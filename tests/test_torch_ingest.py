"""The port's equirect ingest (blinky_tpu_torch.kernels.ingest) against
blinky_tpu's, with tests/test_rgb_source.py and tests/test_equirect_fused.py
as the models.

Inputs come from a NumPy seed and go through the JAX classes (their
``__call__`` jitted on the CPU) and the port's on ``device="cpu"``, where K10's
wrapper runs its plain version.  Tolerance 0 throughout: the tables are NumPy
float64 work on the same libm, the blend rounds every float32 product and sum
on its own in both, and every output is an integer.  The kernel itself runs
only on a card: tests/test_torch_cuda.py holds it to the plain version there.
"""

import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.io.cubemap import equirect_to_cubemap as jequirect_to_cubemap
from blinky_tpu.kernels import ingest as jingest
from blinky_tpu.kernels.remap import RemapKernel as JRemapKernel
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.palette import default_palette
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.io.cubemap import equirect_to_cubemap
from blinky_tpu_torch.kernels import ingest, remap
from blinky_tpu_torch.kernels.remap import RemapKernel
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

PH, PW, S, W, H, B = 64, 128, 48, 64, 48, 4


def _panos(b=B, seed=0, hw=(PH, PW)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, hw + (b,), dtype=np.uint64).astype(np.uint32)


def _same(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _setup(lens_name="panini", zoom=("fov", 180), bilinear=True, globe_name="cube",
           background=None):
    """(JAX ingest, JAX remap, port ingest, port remap) on the same lensmap."""
    jg = jglobes.get(globe_name)
    jl = jlenses.get(lens_name, jg)
    jlm = jbuild(jl, jg, jcalc(JZoom(*zoom), jl, W, H), W, H, S, backend="numpy")
    jremap = JRemapKernel(jlm, default_palette(), background)
    jing = jingest.EquirectIngest(PH, PW, S, globe=jg, bilinear=bilinear)
    g = globes.get(globe_name)
    lens = lenses.get(lens_name, g)
    lm = build_lensmap(lens, g, calc_scale(Zoom(*zoom), lens, W, H), W, H, S)
    remap = RemapKernel(lm, default_palette(), background, device="cpu")
    ing = ingest.EquirectIngest(PH, PW, S, globe=g, bilinear=bilinear, device="cpu")
    return jing, jremap, ing, remap


@pytest.mark.parametrize("globe_name", ["cube", "fast", "tetra"])
@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("hw", [(64, 128), (37, 75)])
def test_build_tables_bit_equal(globe_name, bilinear, hw):
    """The static tables are NumPy float64 work in both packages: equal to
    the last bit, indices and float32 weights, an odd pano size included."""
    jidx, jw = jingest._build_tables(*hw, 24, jglobes.get(globe_name), bilinear)
    idx, w = ingest._build_tables(*hw, 24, globes.get(globe_name), bilinear)
    _same(idx, jidx)
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w.view(np.uint32), jw.view(np.uint32))
    assert idx.min() >= 0 and idx.max() < hw[0] * hw[1]


@pytest.mark.parametrize("globe_name", ["cube", "fast"])
@pytest.mark.parametrize("bilinear", [True, False])
def test_ingest_call_host_and_subset_equal_jax(globe_name, bilinear):
    """__call__ (K10's plain version here), host, subset and host_nearest_u8
    against the JAX class; unused plates all zero, alpha too."""
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    hw = (24, 48)
    panos = _panos(5, seed=4, hw=hw)
    jk = jingest.EquirectIngest(*hw, 16, globe=jg, bilinear=bilinear)
    k = ingest.EquirectIngest(*hw, 16, globe=g, bilinear=bilinear, device="cpu")
    dev = k(panos)
    assert dev.dtype == torch.uint32 and tuple(dev.shape) == (6, 16, 16, 5)
    _same(dev, jk(panos))
    _same(k(torch.from_numpy(panos)), jk(panos))  # a tensor, uint32
    _same(k(torch.from_numpy(panos.view(np.int32))), jk(panos))  # its int32 bits
    out = dev.numpy()
    assert not out[g.numplates:].any()
    for b in range(5):
        _same(k.host(panos[..., b]), jk.host(panos[..., b]))
        np.testing.assert_array_equal(out[..., b], k.host(panos[..., b]))
    rng = np.random.default_rng(9)
    texels = np.unique(rng.integers(0, 6 * 16 * 16, 300))
    sub, jsub = k.subset(texels), jk.subset(texels)
    got = sub(panos)
    assert tuple(got.shape) == (texels.size, 5)
    _same(got, jsub(panos))
    np.testing.assert_array_equal(got.numpy(), out.reshape(-1, 5)[texels])
    _same(sub.host(panos[..., 2]), jsub.host(panos[..., 2]))
    if not bilinear:
        pal_pano = rng.integers(0, 256, hw, dtype=np.uint8)
        _same(k.host_nearest_u8(pal_pano), jk.host_nearest_u8(pal_pano))


@pytest.mark.parametrize("pano_value", [0, 255, "mixed"])
def test_blend_clamp_and_half_ties(pano_value):
    """Channel values 0 and 255 under weights at 0, 1 and 0.5: the clamp and
    the .5 tie of ``acc + 0.5`` are hit, through hand-made tables."""
    rng = np.random.default_rng(3)
    n, rows, batch = 64, 10, 3
    if pano_value == "mixed":
        src = rng.choice(np.array([0, 1, 127, 128, 254, 255], np.uint32), (rows, batch, 4))
    else:
        src = np.full((rows, batch, 4), pano_value, np.uint32)
    src = (src[..., 0] | (src[..., 1] << 8) | (src[..., 2] << 16) | (src[..., 3] << 24))
    idx = rng.integers(0, rows, (4, n)).astype(np.int32)
    w = rng.choice(np.array([0.0, 1.0, 0.5, 0.25, 0.75], np.float32), (4, n))
    w[:, :8] = np.array([[1.0], [0.0], [0.0], [0.0]], np.float32)
    w[:, 8:16] = 0.5  # the sum of four is 2: the clamp at 255
    w[:, 16:24] = np.array([[0.5], [0.5], [0.0], [0.0]], np.float32)  # ties
    want = jingest.EquirectIngest._blend([src[idx[k]] for k in range(4)], w, np)
    got = ingest.equirect_gather(torch.from_numpy(src.view(np.int32)),
                                 torch.from_numpy(idx), torch.from_numpy(w))
    _same(got.view(torch.uint32), want)
    assert (want >> 24 == 0xFF).all()
    # one tap: the row passes through whole, its alpha byte too
    one = ingest.equirect_gather(torch.from_numpy(src.view(np.int32)),
                                 torch.from_numpy(idx[:1]))
    _same(one.view(torch.uint32), src[idx[0]])


@pytest.mark.parametrize("bilinear", [True, False])
@pytest.mark.parametrize("rubix", [False, True])
def test_fused_and_compact_equal_jax(bilinear, rubix):
    jing, jremap, ing, remap = _setup(bilinear=bilinear)
    panos = _panos()
    want = np.asarray(jingest.EquirectScreenKernel(jing, jremap)(panos, rubix=rubix))
    wantc = np.asarray(jingest.CompactEquirectChain(jing, jremap)(panos, rubix=rubix))
    fused = ingest.EquirectScreenKernel(ing, remap)(panos, rubix=rubix)
    compact = ingest.CompactEquirectChain(ing, remap)(panos, rubix=rubix)
    assert fused.dtype == torch.uint32 and tuple(fused.shape) == (H, W, B)
    _same(fused, want)
    _same(compact, wantc)
    _same(remap(ing(panos), rubix=rubix), want)  # the two-stage chain, full faces


@pytest.mark.parametrize("mode", ["fused", "compact"])
@pytest.mark.parametrize("rubix", [False, True])
def test_partial_coverage_lens_with_u32_background(mode, rubix):
    """A contain-fit cartographic lens leaves corners unmapped: they show
    the packed-RGBA background, as the remap's do."""
    rng = np.random.default_rng(5)
    bg = rng.integers(0, 2**32, (H, W), dtype=np.uint64).astype(np.uint32)
    jing, jremap, ing, remap = _setup(lens_name="hammer", zoom=("contain",),
                                      background=bg)
    panos = _panos(seed=2)
    jcls = jingest.EquirectScreenKernel if mode == "fused" else jingest.CompactEquirectChain
    cls = ingest.EquirectScreenKernel if mode == "fused" else ingest.CompactEquirectChain
    got = cls(ing, remap)(panos, rubix=rubix)
    _same(got, jcls(jing, jremap)(panos, rubix=rubix))
    assert (got.numpy()[0, 0] == bg[0, 0]).all()


def test_fused_low_poly_globe_and_u8_background():
    bg = np.full((H, W), 7, np.uint8)
    jing, jremap, ing, remap = _setup(lens_name="fisheye1", zoom=("contain",),
                                      globe_name="tetra", background=bg)
    panos = _panos(seed=6)
    _same(ingest.EquirectScreenKernel(ing, remap)(panos),
          jingest.EquirectScreenKernel(jing, jremap)(panos))
    _same(ingest.CompactEquirectChain(ing, remap)(panos),
          jingest.CompactEquirectChain(jing, jremap)(panos))


def test_composition_and_subset_errors():
    """The checks of ingest.py:239-247, :316-323 and :397-403."""
    _, _, ing, remap = _setup()
    for cls in (ingest.EquirectScreenKernel, ingest.CompactEquirectChain):
        with pytest.raises(TypeError, match="FULL-layout"):
            cls(ing.subset(np.arange(10)), remap)
        bad = ingest.EquirectIngest(PH, PW, S + 2, globe=ing.globe, device="cpu")
        with pytest.raises(ValueError, match="platesize"):
            cls(bad, remap)
        with pytest.raises(ValueError, match="panos must be"):
            cls(ing, remap)(np.zeros((PH, PW + 2, B), np.uint32))
    sub = ing.subset(np.arange(10))
    with pytest.raises(TypeError, match="already a texel subset"):
        sub.subset(np.arange(3))
    with pytest.raises(TypeError, match="full-plate layout"):
        sub.host_nearest_u8(np.zeros((PH, PW), np.uint8))
    with pytest.raises(ValueError, match="panos must be"):
        ing(np.zeros((B, PH, PW), np.uint32))  # wrong layout: batch first
    with pytest.raises(ValueError, match="bilinear=False"):
        ing.host_nearest_u8(np.zeros((PH, PW), np.uint8))
    with pytest.raises(ValueError, match="pano shape"):
        ing.host(np.zeros((PH, PW + 1), np.uint32))
    with pytest.raises(TypeError, match="torch.uint32"):
        ing(torch.zeros((PH, PW, B), dtype=torch.float32))
    # the sharded fused kernel (ported with the multi-GPU slice) refuses a
    # pano batch that does not split evenly over the mesh's data shards
    from blinky_tpu_torch.parallel import equirect_screen_sharded, make_mesh

    mesh3 = make_mesh(3, 1, devices=[torch.device("cpu")] * 3)
    with pytest.raises(ValueError, match="split evenly"):
        equirect_screen_sharded(ingest.EquirectScreenKernel(ing, remap),
                                np.zeros((PH, PW, B), np.uint32), mesh3)


def test_wrapper_checks_operands():
    src = torch.zeros((8, 4), dtype=torch.int32)
    idx = torch.zeros((4, 5), dtype=torch.int32)
    w = torch.zeros((4, 5), dtype=torch.float32)
    flag = torch.zeros(5, dtype=torch.bool)
    word = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="src"):
        ingest.equirect_gather(src.to(torch.uint8), idx, w)
    with pytest.raises(ValueError, match="K 1 or 4"):
        ingest.equirect_gather(src, idx[:2], w[:2])
    with pytest.raises(ValueError, match="weights"):
        ingest.equirect_gather(src, idx)
    with pytest.raises(ValueError, match="w must be"):
        ingest.equirect_gather(src, idx, w.double())
    with pytest.raises(ValueError, match="valid and bg"):
        ingest.equirect_gather(src, idx, w, valid=flag)
    with pytest.raises(ValueError, match="tint_rgb and tint_mask"):
        ingest.equirect_gather(src, idx, w, tint_rgb=word)
    with pytest.raises(ValueError, match="plate_mask"):
        ingest.equirect_gather(src, idx, w, plate_mask=word[:3])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ingest.equirect_gather(src.to("meta"), idx.to("meta"), w.to("meta"))
    assert ingest.equirect_gather.launches == 0


_RING_MIN = remap.RING_MIN_ROW_BYTES


@pytest.mark.parametrize("row_bytes,src_off,out_off,ring", [
    (_RING_MIN - 16, 0, 0, False),       # under the threshold
    (_RING_MIN, 0, 0, True),             # at it
    (_RING_MIN + 16, 0, 0, True),
    (512, 0, 0, True),                   # the 360 cell's rows, B = 128
    (49152, 0, 0, True),                 # a stage's bytes of one tap
    (65536 + 16, 0, 0, True),            # four taps past a stage: in pieces
    (512 + 4, 0, 0, False),              # no multiple of 16 bytes
    (520, 0, 0, False),
    (512, 4, 0, False), (512, 8, 0, False), (512, 12, 0, False),    # pano off 16
    (512, 0, 4, False), (512, 0, 8, False),                         # output off 16
    (512, 16, 48, True),
])
def test_equirect_ring_path_decides_on_row_bytes_and_alignment(row_bytes, src_off, out_off,
                                                               ring):
    """K10 takes its ring by K1's rule, the one function both wrappers
    call: a row of the threshold's bytes or more, a multiple of 16, on
    16-byte aligned pointers."""
    assert ingest.ring_path is remap.ring_path
    base = 1 << 40
    assert ingest.ring_path(row_bytes, base + src_off, base + out_off) is ring


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("B", [_RING_MIN // 4, 128, 8])
def test_equirect_gather_on_the_cpu_runs_the_plain_version(K, B):
    """On the CPU neither counter moves, whatever the row, and the wrapper
    returns the plain version's rows under every epilogue."""
    rng = np.random.default_rng(K * 100 + B)
    rows, n = 40, 257
    src = torch.from_numpy(rng.integers(-2**31, 2**31, (rows, B), dtype=np.int64)
                           .astype(np.int32))
    idx = torch.from_numpy(rng.integers(0, rows, (K, n)).astype(np.int32))
    w = torch.from_numpy(rng.random((K, n), dtype=np.float32)) if K == 4 else None
    word = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32))
    flag = torch.from_numpy(rng.random(n) < 0.5)
    n0, r0 = ingest.equirect_gather.launches, ingest.equirect_gather.ring_launches
    for kw in ({}, dict(plate_mask=word), dict(valid=flag, bg=word),
               dict(valid=flag, bg=word, tint_rgb=word, tint_mask=~flag)):
        got = ingest.equirect_gather(src, idx, w, **kw)
        assert torch.equal(got, ingest.equirect_gather_plain(src, idx, w, **kw))
    assert (ingest.equirect_gather.launches, ingest.equirect_gather.ring_launches) == (n0, r0)


@pytest.mark.parametrize("kind", ["rgb", "rgb_nearest", "palette"])
@pytest.mark.parametrize("globe_name", ["cube", "fast"])
def test_equirect_to_cubemap_equals_jax(kind, globe_name):
    rng = np.random.default_rng(14)
    pano = rng.integers(1, 256, (16, 32, 3) if kind != "palette" else (16, 32), np.uint8)
    kw = dict(platesize=8, bilinear=kind == "rgb")
    got = equirect_to_cubemap(pano, globe=globes.get(globe_name), **kw)
    _same(got, jequirect_to_cubemap(pano, globe=jglobes.get(globe_name), **kw))
    n = globes.get(globe_name).numplates
    assert got[:n].all() and not got[n:].any()
    if kind == "rgb":
        with pytest.raises(ValueError, match="RGB"):
            equirect_to_cubemap(np.zeros((16, 32, 4), np.uint8))


# ------------------------------------------------------------ bench helpers


@pytest.mark.parametrize("h,w,b,chunk", [(5, 7, 3, 2), (16, 32, 130, 256), (9, 4, 1, 4)])
def test_device_pano_equals_jax(h, w, b, chunk):
    from blinky_tpu.bench.throughput import device_pano as jdevice_pano
    from blinky_tpu_torch.bench.throughput import device_pano

    got = device_pano(h, w, b, device="cpu", chunk_rows=chunk)
    assert got.dtype == torch.uint32
    _same(got, jdevice_pano(h, w, b))


@pytest.mark.parametrize("kw", [dict(), dict(texel_compact=True), dict(fused=True),
                                dict(texel_compact=True, rubix=True, bilinear=False)],
                         ids=["faces", "compact", "fused", "compact_rubix_nearest"])
def test_run_equirect_throughput_runs_the_chain(monkeypatch, kw):
    """The chain of each formulation at a tiny shape, with the timer replaced
    by a host clock; the JAX probe's keys, and ``equal``: the chain held to
    the plain versions."""
    import time

    from blinky_tpu_torch.bench import throughput

    seen = []

    def host_ms(fn, iters, warmup=1):
        seen.append(fn())
        t0 = time.perf_counter()
        fn()
        return max((time.perf_counter() - t0) * 1e3, 1e-6)

    monkeypatch.setattr(throughput, "device_ms",
                        lambda fn, iters, device, warmup=1: host_ms(fn, iters, warmup))
    r = throughput.run_equirect_throughput(
        pano_h=32, pano_w=64, platesize=24, width=48, height=36, batch=2, iters=1,
        device="cpu", **kw)
    assert set(r) == {"config", "fps", "ms_per_batch", "equal"} and r["equal"] is True
    assert r["fps"] == pytest.approx(2 / (r["ms_per_batch"] * 1e-3))
    assert tuple(seen[0].shape) == (36, 48, 2) and seen[0].dtype == torch.uint32
    # every formulation renders the Session's screens for the same panos
    from blinky_tpu_torch.api import Session

    sess = Session(48, 36, platesize=24, device="cpu")
    if kw.get("rubix"):
        sess.cmd("f_rubix")
    want = sess.render_equirect(throughput.device_pano(32, 64, 2, device="cpu"),
                                bilinear=kw.get("bilinear", True), mode="faces")
    _same(seen[0], want.numpy())


def test_equirect_byte_models():
    """The bytes a pano lane needs in each mode, and the batch that fits."""
    from blinky_tpu_torch.bench import autobatch

    args = (2048, 4096, 720, 1280, 720)
    pano, faces, screen = 2048 * 4096 * 4, 6 * 720 * 720 * 4, 1280 * 720 * 4
    assert autobatch.equirect_bytes_per_lane(*args, "faces") == pano + faces + screen
    assert autobatch.equirect_bytes_per_lane(*args, "fused") == pano + screen
    assert autobatch.equirect_bytes_per_lane(*args, "compact", 1000) == pano + 4000 + screen
    assert autobatch.equirect_bytes_per_lane(*args, "compact") == pano + faces + screen
    assert autobatch.equirect_table_bytes(720, 1280, 720, "fused") == 32 * 1280 * 720
    assert autobatch.equirect_table_bytes(720, 1280, 720, "fused", bilinear=False) == 4 * 1280 * 720
    assert autobatch.equirect_table_bytes(720, 1280, 720, "faces") == 36 * 6 * 720 * 720
    assert autobatch.equirect_table_bytes(720, 1280, 720, "compact", True, 1000) == (
        36 * 1000 + 4 * 1280 * 720)
    lane = pano + screen
    tables = 32 * 1280 * 720
    assert autobatch.equirect_feasible_batch(*args, "fused", budget=tables + 10 * lane + 5) == 10
    assert autobatch.equirect_feasible_batch(*args, "fused", budget=1) == 1
