"""The supersampled cell, ``pc1080.render_aa``, rehearsed through the
harness on the CPU at the shared tiny size: its spans traced, its control
and faults caught, its readers (``k11_roofline``, ``aa_decode_roofline``)
on synthetic traces, and the counts they read; on a card, every kernel of
its traced window named by a reader."""

import time

import numpy as np
import pytest
import torch

from benchmark import aa_decode_bytes, control, harness, k11_bytes, rooflines, trace
from benchmark.drivers import aa_card
from benchmark.reference import lensmap as ref_lensmap
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX
from blinky_tpu_torch import api

SPEC = harness.benchmark_spec()
CELL = "pc1080.render_aa"


def _run(traced=False, seed=2**31 + 3, device="cpu", seconds=0.3, small=True):
    return harness.run_cell(SPEC, CELL, seed, seconds, traced, device=device,
                            t_start=time.perf_counter(),
                            cfg_override=SMALL_CFG if small else None,
                            mix_override={**SMALL_MIX, "trace_seconds": 0.1} if small else None)


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_rehearses_on_the_cpu(traced):
    res, run = _run(traced)
    assert res["correct"] is True and res["checks"]["screen_mismatch"]["value"] == 0.0
    assert run.calls == res["attempted"] > 0
    assert run.screens == run.calls * SMALL_MIX["batch"]
    if not traced:
        assert set(res["metrics"]) == {"setup_s", "screens_per_s"}
        return
    names = {s.name for s in run.trace.spans}
    assert {"bench.render", "session.render_aa", "aa.decode", "session.render"} <= names
    m = res["metrics"]
    assert m["rebuilds_in_window"]["value"] == 0 and m["entry_self_ms"]["value"] > 0
    # no kernel records on the CPU: the device's metrics stay silent
    assert not {"k1_roofline", "k11_roofline", "aa_decode_roofline",
                "device_idle_pct.throughput"} & set(m)


def test_the_limit_lies_under_a_third_of_the_control():
    """The control, the reference one precision down, reads over three
    times the limit on every seed (the generic control test asks only
    that it fail)."""
    _, _, mix = harness.resolve(SPEC, CELL)
    limit = mix["limits"]["screen_mismatch"]
    readings = list(control.readings(CELL, [4, 2**31 + 5, 2**33 + 6], 0.2, False, device="cpu",
                                     cfg_override=SMALL_CFG, mix_override=SMALL_MIX, spec=SPEC))
    assert all(r["screen_mismatch"] > 3 * limit for _, r in readings), readings


def _half_batch(out):
    out = out.clone()
    out[..., out.shape[-1] // 2:] = 0
    return out


def _shifted_lane(out):
    out = out.clone()
    out[..., 0] = torch.roll(out[..., 0], 1, dims=0)
    return out


@pytest.mark.parametrize("fault", [_half_batch, _shifted_lane])
def test_an_output_fault_is_caught(monkeypatch, fault):
    orig = api.Session.render_aa
    monkeypatch.setattr(api.Session, "render_aa",
                        lambda self, *a, **k: fault(orig(self, *a, **k)))
    assert _run()[0]["correct"] is False


def test_the_palette_is_a_function_of_the_seed():
    a, b, c = aa_card.palette(2**31 + 9), aa_card.palette(2**31 + 9), aa_card.palette(10)
    assert a.shape == (256, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_a_session_off_the_seeded_palette_is_caught(monkeypatch):
    """The session decodes through another palette than the check's: the
    seeded one with red and blue swapped."""
    orig = api.Session.render_aa

    def swapped(self, *a, **k):
        if not getattr(self, "_swapped", False):
            self.palette, self._swapped = np.ascontiguousarray(self.palette[:, ::-1]), True
        return orig(self, *a, **k)

    monkeypatch.setattr(api.Session, "render_aa", swapped)
    res, run = _run()
    assert np.array_equal(run.state["palette"], aa_card.palette(2**31 + 3))
    assert res["correct"] is False


def test_the_check_states_the_kernels_counts():
    _, run = _run()
    W, H, S = (SMALL_CFG[k] for k in ("width", "height", "platesize"))
    B, k = SMALL_MIX["batch"], 2
    flat, valid = ref_lensmap.build("panini", "cube", 180, k * W, k * H, S)
    rows = int(torch.unique(flat[valid]).numel())
    assert run.facts == {
        "k1_bytes": rooflines.gather_bytes(rows, k * W * k * H, B, 4),
        "k11_bytes": (k * W * k * H + W * H) * B * 4,
        "aa_decode_bytes": 5 * 6 * S * S * B,
    }


def test_the_counts_by_hand():
    # K11 on 3 lanes of a 4x2 screen at factor 3: the 12x6 screen's 72
    # words read and 8 written a lane, 4 bytes each
    assert k11_bytes.nbytes(4, 2, 3, 3) == (72 + 8) * 3 * 4
    # the decode of 2 lanes of 6 planes of 5x5: a byte read and 4 written
    # a texel
    assert aa_decode_bytes.nbytes(6, 5, 2) == 6 * 25 * 2 * (1 + 4)
    # the cell's call, B = 256 at 1080p: K11 3.17 ms, the decode 2.67 ms
    assert k11_bytes.nbytes(1920, 1080, 2, 256) / rooflines.HBM_BYTES_PER_S == pytest.approx(
        3.1692e-3, rel=1e-4)
    assert aa_decode_bytes.nbytes(6, 1080, 256) / rooflines.HBM_BYTES_PER_S == pytest.approx(
        2.6740e-3, rel=1e-4)


# ------------------------------------------------------------ the readers


def _span(name, ts, dur, cat="user_annotation"):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


class _Run:
    def __init__(self, events, facts=None):
        self.trace = trace.from_events(events)
        self.facts = facts or {}


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


COPY = "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(x)>"
SELECT = "void at::native::_scatter_gather_elementwise_kernel<128, 8, (x)>(int, (x))"
K11 = "void (anonymous namespace)::downsample_kernel<uint4>(x)"


def _calls(decode=True):
    ev = [
        _span(trace.WINDOW, 1000, 1000),
        # cut by the window's start: left out
        _span("session.render_aa", 950, 100), _span("aa.decode", 960, 30),
        # two calls, each a decode of two pieces
        _span("session.render_aa", 1100, 300), _span("aa.decode", 1110, 100),
        _span("session.render_aa", 1500, 300), _span("aa.decode", 1510, 100),
        _span(COPY, 1100, 20, "kernel"), _span(SELECT, 1120, 30, "kernel"),
        _span(COPY, 1150, 20, "kernel"), _span(SELECT, 1170, 30, "kernel"),
        _span(K11, 1300, 80, "kernel"),
        _span(COPY, 1500, 20, "kernel"), _span(SELECT, 1520, 30, "kernel"),
        _span(COPY, 1550, 20, "kernel"), _span(SELECT, 1570, 30, "kernel"),
        _span(K11, 1700, 80, "kernel"),
        _span(K11, 1950, 100, "kernel"),  # cut by the window's end: left out
    ]
    return ev if decode else [e for e in ev if e["name"] != "aa.decode"]


def test_the_decode_share_reads_its_spans_and_records():
    facts = {"aa_decode_bytes": rooflines.HBM_BYTES_PER_S * 50e-6}
    # two calls of 50 us of bytes each over 200 us of decode records
    assert _read("aa_decode_roofline", _Run(_calls(), facts)) == pytest.approx(
        100.0 * 2 * 50e-6 / 200e-6)


def test_the_decode_share_reads_nothing_without_its_span():
    """The parent's program has no ``aa.decode``: no value, no error."""
    facts = {"aa_decode_bytes": 1e6}
    assert _read("aa_decode_roofline", _Run(_calls(decode=False), facts)) is None
    assert _read("aa_decode_roofline", _Run(_calls())) is None  # no count from the check
    run = _Run(_calls(), facts)
    run.trace = None
    assert _read("aa_decode_roofline", run) is None


def test_k11_roofline_reads_whole_records():
    run = _Run(_calls(), {"k11_bytes": rooflines.HBM_BYTES_PER_S * 40e-6})
    assert _read("k11_roofline", run) == pytest.approx(100.0 * 40e-6 / 80e-6)
    assert _read("k11_roofline", _Run(_calls())) is None
    run.trace = None
    assert _read("k11_roofline", run) is None


# -------------------------------------------------------------- on a card


@pytest.mark.cuda
def test_every_kernel_of_the_traced_window_is_read(cuda_device):
    """At the cell's own size on the card, each kernel record of the traced
    window is K1's, K11's or the decode's, and the readers read them."""
    k1 = harness.load_module("metrics", "k1_roofline").KERNEL
    k11 = harness.load_module("metrics", "k11_roofline").KERNEL
    decode = harness.load_module("metrics", "aa_decode_roofline")
    res, run = _run(True, seed=2**31 + 11, device="cuda:0", seconds=2.0, small=False)
    assert res["correct"] is True, res["checks"]
    kernels = [r for r in run.trace.device if r.cat == "kernel"]
    assert kernels
    named = {r.name for r in kernels
             if k1 in r.name or k11 in r.name or any(n in r.name for n in decode.KERNELS)}
    assert {r.name for r in kernels} == named
    m = res["metrics"]
    for name in ("k1_roofline", "k11_roofline", "aa_decode_roofline"):
        assert 0 < m[name]["value"] <= 100, (name, m[name])
    assert m["rebuilds_in_window"]["value"] == 0
    assert {"entry_self_ms", "launch_wait_ms"} <= set(m)
