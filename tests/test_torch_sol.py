"""The port's speed-of-light probes (blinky_tpu_torch.bench.sol) against
blinky_tpu's Pallas kernels, run in interpret mode on the CPU as
tests/test_sol.py runs them, and against the JAX probes' arithmetic.
Tolerance 0: the outputs are integers (the bf16 products are small
integers, exact in bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import blinky_tpu.bench.sol as jsol
from blinky_tpu.bench.sol import _stream_read_kernel, pallas_onehot_gather_call
from blinky_tpu_torch.bench import sol


def _pallas_stream_read(x, block_rows):
    """blinky_tpu/bench/sol.py:244-255: the pallas_call of
    pallas_stream_read, in interpret mode."""
    rows = x.shape[0]
    return pl.pallas_call(
        _stream_read_kernel,
        grid=(rows // block_rows,),
        in_specs=[pl.BlockSpec((block_rows, 1024), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, 1), lambda i: (0, 0),
                               memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.int32),
        interpret=True,
    )(x)


@pytest.mark.parametrize("W,T,R,B,hi,lo", [
    (2, 16, 32, 128, 128, 0),      # tests/test_sol.py's shape, int8-safe values
    (3, 8, 24, 40, 256, -5),       # every u8 value; rows outside [0, R)
])
def test_onehot_gather_plain_equals_pallas(W, T, R, B, hi, lo):
    rng = np.random.default_rng(W * 100 + B)
    idx = rng.integers(lo, R + (-lo), (W, T)).astype(np.int32)
    src = rng.integers(0, hi, (W, R, B)).astype(np.uint8)
    expect = np.asarray(pallas_onehot_gather_call(
        jnp.asarray(idx), jnp.asarray(src), interpret=True))
    got = sol.onehot_gather(torch.from_numpy(idx), torch.from_numpy(src))
    assert got.dtype == torch.uint8 and got.shape == (W, T, B)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("W,T,R,B,idx_kind,src_kind", [
    (1, 191, 130, 16, "mixed", "u8"),     # K3's tile edges: T = 192 - 1, R = 128 + 2
    (1, 193, 127, 17, "mixed", "u8"),     # T = 192 + 1, R = 128 - 1, B ragged
    (2, 9, 129, 127, "mixed", "u8"),      # R = 128 + 1, B = 128 - 1
    (1, 12, 40, 129, "mixed", "u8"),      # B = 128 + 1
    (2, 30, 1, 32, "mixed", "u8"),        # R = 1
    (2, 24, 50, 48, "out_of_range", "u8"),  # every row empty: -1, R, 2^31 - 1
    (2, 24, 50, 48, "mixed", "all255"),   # 255 is -1 as int8 and wraps back
])
def test_onehot_gather_edges_equal_pallas(W, T, R, B, idx_kind, src_kind):
    rng = np.random.default_rng(T * 1000 + R + B)
    if idx_kind == "out_of_range":
        idx = rng.choice(np.array([-1, R, 2**31 - 1], np.int32), (W, T))
    else:
        idx = rng.integers(-2, R + 2, (W, T)).astype(np.int32)
    if src_kind == "all255":
        src = np.full((W, R, B), 255, np.uint8)
    else:
        src = rng.integers(0, 256, (W, R, B)).astype(np.uint8)
    expect = np.asarray(pallas_onehot_gather_call(
        jnp.asarray(idx), jnp.asarray(src), interpret=True))
    got = sol.onehot_gather(torch.from_numpy(idx), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), expect)
    if idx_kind == "out_of_range":
        assert not expect.any()


@pytest.mark.parametrize("windows,t_rows,screen_pixels,seconds", [
    (64, 384, 1920 * 1080, 0.0123),    # the full-size probe's shape
    (2, 128, 1920 * 1080, 0.00437),    # bench.py --sol --quick's
    (3, 7, 1000, 0.5),                 # a screen that is not a multiple of T
    (64, 384, 640 * 480, 0.000093),
])
def test_full_screen_ms_equals_jax(monkeypatch, windows, t_rows, screen_pixels,
                                   seconds):
    """blinky_tpu/bench/sol.py:214-218's extrapolation, with its timer
    replaced by a fixed time so that no kernel runs."""
    iters = 4
    monkeypatch.setattr(jsol, "_run_timed", lambda *a, **k: seconds * iters)
    expect = jsol.pallas_onehot_gather(windows, t_rows, 16, 8, iters=iters,
                                       screen_pixels=screen_pixels,
                                       interpret=True)["full_screen_ms"]
    got = sol.full_screen_ms(seconds * 1e3, windows, t_rows, screen_pixels)
    assert round(got, 1) == expect
    assert got == pytest.approx(
        seconds * -(-screen_pixels // t_rows) / windows * 1e3, rel=1e-12)


@pytest.mark.parametrize("m,k,n,dtype", [
    (17, 32, 8, "int8"),
    (48, 256, 128, "int8"),
    (24, 32, 16, "bf16"),
])
def test_matmul_product_equals_dot_general(m, k, n, dtype):
    """mxu_matmul's product against blinky_tpu/bench/sol.py:131's
    dot_general: int8 with int32 sums over every int8 value; bf16 on small
    integers, whose products and sums bf16 holds exactly."""
    rng = np.random.default_rng(m * k + n)
    lo, hi = (-128, 128) if dtype == "int8" else (-2, 3)
    a = rng.integers(lo, hi, (m, k))
    b = rng.integers(lo, hi, (k, n))
    jdt, acc = (jnp.int8, jnp.int32) if dtype == "int8" else (jnp.bfloat16, jnp.float32)
    expect = np.asarray(jax.lax.dot_general(
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), (((1,), (0,)), ((), ())),
        preferred_element_type=acc)).astype(np.float64)
    tdt = torch.int8 if dtype == "int8" else torch.bfloat16
    got = sol.matmul_product(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    assert got.dtype == (torch.int32 if dtype == "int8" else torch.bfloat16)
    np.testing.assert_array_equal(got.double().numpy(), expect)


@pytest.mark.parametrize("rows,block_rows,fill", [
    (64, 16, None),        # random bytes
    (10240, 2048, 255),    # 255 * 10 MiB > 2^31: the int32 sum wraps
])
def test_stream_read_plain_equals_pallas(rows, block_rows, fill):
    rng = np.random.default_rng(rows)
    if fill is None:
        x = rng.integers(0, 256, (rows, 1024), dtype=np.uint8)
    else:
        x = np.full((rows, 1024), fill, np.uint8)
    expect = np.asarray(_pallas_stream_read(jnp.asarray(x), block_rows))
    got = sol.stream_read(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (1, 1)
    np.testing.assert_array_equal(got.numpy(), expect)
    if fill is not None:
        assert int(x.sum(dtype=np.int64)) > 2**31  # the case does wrap


def test_wrappers_check_operands():
    with pytest.raises(ValueError, match="src"):
        sol.onehot_gather(torch.zeros((2, 3), dtype=torch.int32),
                          torch.zeros((2, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="idx"):
        sol.onehot_gather(torch.zeros((3, 3), dtype=torch.int32),
                          torch.zeros((2, 4, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="1024"):
        sol.stream_read(torch.zeros((4, 512), dtype=torch.uint8))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sol.stream_read(torch.zeros((4, 1024), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        sol.onehot_gather(torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                          torch.zeros((2, 4, 8), dtype=torch.uint8, device="meta"))
    assert sol.onehot_gather.launches == 0 and sol.stream_read.launches == 0


def test_timer_needs_a_card():
    """A measurement with no card fails; it never times the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        sol.cuda_ms(lambda: None, iters=1)


def _host_ms(fn, iters, warmup=1):
    """A host-clock stand-in for cuda_ms, so the probes' bodies run here."""
    import time

    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return max((time.perf_counter() - t0) * 1e3 / iters, 1e-6)


@pytest.mark.parametrize("probe,jkw,kw", [
    ("stream_copy", dict(nbytes=1 << 16, iters=2), dict(nbytes=1 << 16, iters=2)),
    ("row_gather", dict(n_rows=1 << 10, row_bytes=128, n_idx=1 << 9, iters=2),
     dict(n_rows=1 << 10, row_bytes=128, n_idx=1 << 9, iters=2)),
    ("element_gather", dict(n_elems=1 << 12, n_idx=1 << 10, iters=2),
     dict(n_elems=1 << 12, n_idx=1 << 10, iters=2)),
])
def test_xla_probes_return_the_jax_probes_keys(monkeypatch, probe, jkw, kw):
    """stream_copy, row_gather and element_gather: the JAX probes' keys and
    their counted values (bytes, rows, indices), with the timer replaced by
    a host clock so that the bodies run on the CPU."""
    monkeypatch.setattr(sol, "cuda_ms", _host_ms)
    want = getattr(jsol, probe)(**jkw)
    got = getattr(sol, probe)("cpu", **kw)
    assert set(got) == set(want)
    for key in set(want) - {"ms", "gbps", "ns_per_index"}:
        assert got[key] == want[key], key
    assert got["ms"] > 0 and got["gbps"] > 0


@pytest.mark.parametrize("n_idx,rows", [(1 << 10, 1 << 8), (300_000, 6 * 1080 * 1080),
                                        (1 << 19, 1 << 24)])
def test_gather_probe_indices_equal_jax(n_idx, rows):
    """The scattered index pattern, whose int32 product wraps past 271,186
    indices: equal to jnp's, and always inside the source."""
    want = np.asarray(jnp.arange(n_idx, dtype=jnp.int32) * 7919 % rows)
    got = sol.gather_probe_indices(n_idx, rows, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.min()) >= 0 and int(got.max()) < rows


def test_run_sol_lists_every_probe(monkeypatch):
    """run_sol's order and shapes, with every probe replaced by a recorder."""
    calls = []
    for name in ("stream_copy", "row_gather", "element_gather", "onehot_probe",
                 "stream_read_probe", "mxu_matmul"):
        monkeypatch.setattr(sol, name, lambda device, _n=name, **kw: calls.append((_n, kw))
                            or dict(probe=_n))
    out = sol.run_sol("cpu")
    assert [c[0] for c in calls] == [
        "stream_copy", "row_gather", "row_gather", "element_gather", "onehot_probe",
        "onehot_probe", "stream_read_probe", "mxu_matmul", "mxu_matmul"]
    assert [c[1].get("row_bytes") for c in calls[1:3]] == [1024, 128]
    assert len(out) == 9
