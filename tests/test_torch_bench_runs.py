"""Each ``run_*`` of blinky_tpu_torch/bench/throughput.py once on the CPU at
64x48, S = 48, B = 4, against its blinky_tpu.bench.throughput original: the
same keys (the port may return more) and the same ``config`` string.  The
screens both packages produce are compared too: K1's plain version on every
source layout bit for bit, and the float32 device builds of the pose-tracked
chunks within the reference's boundary tolerance (0.15 of the pixels at
64x48, as tests/test_torch_lenses.py holds the float32 builders).

Both packages' static remaps take the exact host lensmap here: the port's
always does (its texel counts are the planner's), and the JAX module's
``build_lensmap`` is pointed at its NumPy backend so that the texel, row and
plane counts in the two config strings come from one table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.bench import throughput as jt
from blinky_tpu.kernels import remap as jremap
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.palette import default_palette as jpalette
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.bench import throughput as tt
from blinky_tpu_torch.kernels.remap import remap_gather
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

W, H, S, B = 64, 48, 48, 4
SMALL = dict(width=W, height=H, platesize=S)

MODES = {
    "full rubix": dict(),
    "full": dict(rubix=False),
    "full rgba": dict(rubix=False, rgba=True),
    "full rubix rgba": dict(rgba=True),
    "compact rubix": dict(compact=True),
    "compact rgba": dict(rubix=False, rgba=True, compact=True),
    "compact rubix rgba": dict(rgba=True, compact=True),
    "postgather": dict(rgba=True, tint_post=True),
    "postgather compact": dict(rgba=True, tint_post=True, compact=True),
    "rowcrop": dict(rubix=False, row_crop=True),
    "rowcrop rubix rgba": dict(rgba=True, row_crop=True),
    "texels": dict(rubix=False, texel_compact=True),
    "texels rubix": dict(texel_compact=True),
    "texels rubix rgba": dict(rgba=True, texel_compact=True),
}


@pytest.fixture
def exact_jax(monkeypatch):
    monkeypatch.setattr(jt, "build_lensmap",
                        lambda *a, **kw: jbuild(*a, **{**kw, "backend": "numpy"}))


def _keys(port, ref):
    assert set(ref) <= set(port), set(ref) - set(port)
    assert port["config"] == ref["config"]


def _jax_screen(mode):
    """The JAX package's K1 screen for one of run_gather_throughput's
    layouts at B lanes: its own sources, compactions and gathers."""
    kw = {"rubix": True, "rgba": False, **MODES[mode]}
    rubix, rgba = kw["rubix"], kw["rgba"]
    g = jglobes.get("cube")
    lens = jlenses.get("panini", g)
    lm = jbuild(lens, g, calc_scale(Zoom("fov", 180), lenses.get("panini", globes.get("cube")),
                                    W, H), W, H, S, backend="numpy")
    kern = jremap.RemapKernel(lm, jpalette())
    bg = kern.background_rgba if rgba else kern.background
    if kw.get("tint_post"):
        if kw.get("compact"):
            plane_ids, idx = jremap.compact_planes(lm, rubix=False)
            frames = jt.device_source(S, B, False, True, plane_ids)
        else:
            idx, frames = lm.flat_idx, jt.device_source(S, B, False, True)
        return jremap.remap_gather_tint_impl(frames, jnp.asarray(idx), lm.valid, bg,
                                             *kern.tint_rgb_mask)
    if kw.get("texel_compact"):
        texels, idx = jremap.compact_texels(lm, rubix=rubix)
        frames = jt.device_source_texels(S, B, rgba, texels)
    elif kw.get("row_crop"):
        slabs, idx = jremap.compact_rows(lm, rubix=rubix)
        frames = jt.device_source_rows(S, B, rgba, slabs)
    elif kw.get("compact"):
        plane_ids, idx = jremap.compact_planes(lm, rubix=rubix)
        frames = jt.device_source(S, B, rubix, rgba, plane_ids)
    else:
        idx = jremap.expanded_flat_idx(lm) if rubix else lm.flat_idx
        frames = jt.device_source(S, B, rubix, rgba)
    return jremap.remap_gather_impl(frames, jnp.asarray(idx), lm.valid, bg)


@pytest.mark.parametrize("mode", list(MODES))
def test_gather_screens_equal_jax(mode):
    config, src, idx, valid, bg, tint = tt.gather_operands(batch=B, **SMALL, **MODES[mode],
                                                           device="cpu")
    got = remap_gather(src, idx, valid, bg, **tint).reshape(H, W, B).numpy()
    ref = np.asarray(_jax_screen(mode))
    np.testing.assert_array_equal(got.view(np.uint32) if got.dtype == np.int32 else got, ref)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_gather_throughput_keys_equal_jax(mode, exact_jax):
    port = tt.run_gather_throughput(batch=B, iters=2, **SMALL, **MODES[mode], device="cpu")
    ref = jt.run_gather_throughput(batch=B, iters=2, **SMALL, **MODES[mode])
    _keys(port, ref)
    assert port["equal"] and port["batch"] == B


def test_run_gather_throughput_derives_the_jax_batch(exact_jax, monkeypatch):
    """batch=None: both planners on the same budget derive the same batch
    (the port's bench budget is handed the JAX one)."""
    from blinky_tpu.bench import autobatch as jab
    from blinky_tpu_torch.bench import autobatch as ab

    monkeypatch.setenv("BLINKY_HBM_BYTES", "40000000")
    monkeypatch.setattr(ab, "EFFECTIVE_FRACTION", jab.EFFECTIVE_FRACTION)
    port = tt.run_gather_throughput(batch=None, iters=1, **SMALL, rubix=False,
                                    texel_compact=True, device="cpu")
    ref = jt.run_gather_throughput(batch=None, iters=1, **SMALL, rubix=False,
                                   texel_compact=True)
    _keys(port, ref)
    assert port["batch"] % ab.QUANTUM == 0 and port["equal"]


@pytest.mark.parametrize("rubix,decode_rgb", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_run_throughput_keys_equal_jax(rubix, decode_rgb):
    kw = dict(batch=B, iters=2, rubix=rubix, decode_rgb=decode_rgb, **SMALL)
    _keys(tt.run_throughput(**kw, device="cpu"), jt.run_throughput(**kw))


def test_run_pose_tracked_throughput_keys_equal_jax():
    kw = dict(batch=B, iters=2, **SMALL)
    _keys(tt.run_pose_tracked_throughput(**kw, device="cpu"),
          jt.run_pose_tracked_throughput(**kw))


@pytest.mark.parametrize("chunk", [0, 3, 40])
def test_pose_tracked_builds_equal_jax_within_tolerance(chunk):
    """The chunk's float32 device build against the JAX float32 builder's
    on the same basis."""
    g, jg = globes.get("cube"), jglobes.get("cube")
    lens, jlens = lenses.get("panini", g), jlenses.get("panini", jg)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    basis = tt.pose_track_basis(chunk)
    got = build_lensmap(lens, g, scale, W, H, S, backend="torch", view_basis=basis,
                        device="cpu").to_numpy()
    ref = jbuild(jlens, jg, scale, W, H, S, view_basis=basis).to_numpy()
    assert np.mean(got.flat_idx != ref.flat_idx) <= 0.15
    assert np.mean(got.valid != ref.valid) <= 0.15
    assert chunk or np.array_equal(basis[0], np.array([0, 0, 1], np.float32))


def test_run_batch_scaling_keys_equal_jax():
    kw = dict(batches=(2, B), iters=2, **SMALL)
    port, ref = tt.run_batch_scaling(**kw, device="cpu"), jt.run_batch_scaling(**kw)
    assert [set(r) - {"equal"} for r in port] == [set(r) for r in ref]
    assert [r["batch"] for r in port] == [r["batch"] for r in ref]
    assert all(r["equal"] for r in port)


@pytest.mark.parametrize("name", ["run_per_frame_pose_throughput",
                                  "run_static_ray_pose_throughput",
                                  "run_forward_posed_throughput"])
def test_run_posed_throughputs_keys_equal_jax(name):
    kw = dict(batch=B, reps=2, **SMALL)
    _keys(getattr(tt, name)(**kw, device="cpu"), getattr(jt, name)(**kw))


@pytest.mark.parametrize("lens_name", ["stereographic", "eckert1"])
def test_run_build_bench_keys_equal_jax(lens_name):
    kw = dict(width=W, height=H, lens_name=lens_name, fovs=(90, 120, 150), device_iters=3)
    port, ref = tt.run_build_bench(**kw, device="cpu"), jt.run_build_bench(**kw)
    assert set(port) - {"equal"} == set(ref) and port["equal"]
    assert (port["device_ms"] is None) == (ref["device_ms"] is None) == (lens_name == "eckert1")


@pytest.mark.parametrize("kw", [dict(), dict(rubix=True), dict(bilinear=False),
                                dict(texel_compact=True), dict(fused=True)])
def test_run_equirect_throughput_keys_equal_jax(kw):
    size = dict(pano_h=32, pano_w=64, platesize=24, width=48, height=36, batch=B, iters=2)
    _keys(tt.run_equirect_throughput(**size, **kw, device="cpu"),
          jt.run_equirect_throughput(**size, **kw))


def test_measurement_frees_the_screen_before_timing(monkeypatch):
    """The live set while K1 is timed is the planner's, the source and one
    screen: the checked full-batch screen is gone before the first timed
    launch, and the plain version runs only on the checked lane slices, a
    piece of pixels at a time."""
    import weakref

    config, src, idx, valid, bg, tint = tt.gather_operands(batch=300, **SMALL, rubix=False,
                                                           texel_compact=True, device="cpu")
    screens, plain_widths = [], []
    real_plain = tt.remap_gather_plain

    def plain(s, idx_, *a, **kw):
        plain_widths.append((s.shape[1], idx_.numel()))
        return real_plain(s, idx_, *a, **kw)

    def timed(fn, iters, device, warmup=1):
        assert all(r() is None for r in screens)
        return 1.0

    def gather(*a, **kw):
        out = remap_gather(*a, **kw)
        screens.append(weakref.ref(out))
        return out

    monkeypatch.setattr(tt, "remap_gather", gather)
    monkeypatch.setattr(tt, "remap_gather_plain", plain)
    monkeypatch.setattr(tt, "device_ms", timed)
    monkeypatch.setattr(tt, "CHECK_PIXELS", 1000)
    r = tt._time_gather(src, idx, valid, bg, tint, 3, "cpu", False)
    assert r["equal"] and len(screens) == 1
    # two lane slices, each in pieces of at most CHECK_PIXELS pixels
    assert plain_widths == [(tt.CHECK_LANES, n) for n in (1000, 1000, 1000, 72)] * 2
    assert r["source_rows"] == src.shape[0]
    assert r["bound_bytes"] == idx.numel() * 6 + (src.shape[0] + idx.numel()) * 300


def test_the_check_catches_a_wrong_lane(monkeypatch):
    """A K1 whose last lane is off fails ``equal``."""
    config, src, idx, valid, bg, tint = tt.gather_operands(batch=200, **SMALL, rubix=False,
                                                           texel_compact=True, device="cpu")

    def wrong(*a, **kw):
        out = remap_gather(*a, **kw)
        out[:, -1] += 1
        return out

    monkeypatch.setattr(tt, "remap_gather", wrong)
    assert not tt._time_gather(src, idx, valid, bg, tint, 1, "cpu", False)["equal"]


def test_plain_checks_the_whole_batch(monkeypatch):
    """With *plain* (room for two more screens) K1's whole output is held to
    the whole plain output, so a wrong lane in the middle shows."""
    config, src, idx, valid, bg, tint = tt.gather_operands(batch=300, **SMALL, rubix=False,
                                                           texel_compact=True, device="cpu")
    widths = []
    real_plain = tt.remap_gather_plain

    def plain(s, *a, **kw):
        widths.append(s.shape[1])
        return real_plain(s, *a, **kw)

    monkeypatch.setattr(tt, "remap_gather_plain", plain)
    assert tt._time_gather(src, idx, valid, bg, tint, 1, "cpu", True)["equal"]
    assert widths[0] == 300

    def wrong(*a, **kw):
        out = remap_gather(*a, **kw)
        out[:, 150] += 1
        return out

    monkeypatch.setattr(tt, "remap_gather", wrong)
    assert not tt._time_gather(src, idx, valid, bg, tint, 1, "cpu", True)["equal"]


def _off_by_one(fn, index=-1):
    """*fn* with one lane, pose or pixel of its output changed."""
    def wrong(*a, **kw):
        out = fn(*a, **kw)
        bits = out.view(torch.int32) if out.dtype == torch.uint32 else out
        bits[index] += 1
        return out
    return wrong


def test_run_throughput_catches_a_wrong_remap(monkeypatch):
    """The plain remap's K1 and the rubix/decode remap's K2, each checked."""
    from blinky_tpu_torch.kernels import remap as rm

    kw = dict(batch=B, iters=1, **SMALL, device="cpu")
    assert tt.run_throughput(**kw)["equal"]
    monkeypatch.setattr(tt, "remap_gather", _off_by_one(rm.remap_gather, (slice(None), -1)))
    assert not tt.run_throughput(**kw)["equal"]
    assert tt.run_throughput(**kw, rubix=True)["equal"]
    monkeypatch.setattr(tt, "remap_lut", _off_by_one(rm.remap_lut, (slice(None), -1)))
    assert not tt.run_throughput(**kw, rubix=True)["equal"]
    assert not tt.run_throughput(**kw, decode_rgb=True)["equal"]


def test_the_pose_tracked_and_scaling_runs_catch_a_wrong_k1(monkeypatch):
    from blinky_tpu_torch.kernels import remap as rm

    monkeypatch.setattr(tt, "remap_gather", _off_by_one(rm.remap_gather, (slice(None), -1)))
    assert not tt.run_pose_tracked_throughput(batch=B, iters=1, **SMALL,
                                              device="cpu")["equal"]
    assert [r["equal"] for r in tt.run_batch_scaling(
        batches=(2, B), iters=1, **SMALL, device="cpu")] == [False, False]


@pytest.mark.parametrize("field", tt.LENSMAP_FIELDS)
def test_build_equal_catches_a_wrong_k8(monkeypatch, field):
    from blinky_tpu_torch.lensmap import builder

    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    args = (lens, g, scale, W, H, S)
    assert tt.build_equal(*args, device="cpu")
    assert tt.build_equal(*args, tt.pose_track_basis(3), device="cpu")
    real = builder.lensmap_resolve

    def wrong(*a, **kw):
        out = real(*a, **kw)
        out[field] = ~out[field] if out[field].dtype == torch.bool else out[field] + 1
        return out

    monkeypatch.setattr(builder, "lensmap_resolve", wrong)
    assert not tt.build_equal(*args, device="cpu")
    # a forward lens builds on the host: no K8 to hold
    assert tt.build_equal(lenses.get("eckert1", g), g, scale, W, H, S, device="cpu")


@pytest.mark.parametrize("name", ["run_per_frame_pose_throughput",
                                  "run_static_ray_pose_throughput",
                                  "run_forward_posed_throughput"])
def test_the_posed_runs_catch_a_wrong_k6(monkeypatch, name):
    from blinky_tpu_torch.kernels import static_ray

    kw = dict(batch=10, reps=1, **SMALL, device="cpu")  # two check pieces of poses
    assert getattr(tt, name)(**kw)["equal"]
    monkeypatch.setattr(static_ray, "static_ray_posed",
                        _off_by_one(static_ray.static_ray_posed))
    assert not getattr(tt, name)(**kw)["equal"]


def test_the_forward_run_catches_a_wrong_k5(monkeypatch):
    from blinky_tpu_torch.kernels import posed

    monkeypatch.setattr(posed, "gather_posed", _off_by_one(posed.gather_posed, 0))
    assert not tt.run_forward_posed_throughput(batch=B, reps=1, **SMALL,
                                               device="cpu")["equal"]


@pytest.mark.parametrize("kw", [dict(), dict(rubix=True), dict(bilinear=False),
                                dict(texel_compact=True), dict(fused=True)])
def test_the_equirect_run_catches_a_wrong_k10(monkeypatch, kw):
    from blinky_tpu_torch.kernels import ingest

    size = dict(pano_h=32, pano_w=64, platesize=24, width=48, height=36, batch=20, iters=1,
                device="cpu")  # both ends of the batch checked
    assert tt.run_equirect_throughput(**size, **kw)["equal"]
    monkeypatch.setattr(ingest, "equirect_gather",
                        _off_by_one(ingest.equirect_gather, (slice(None), -1)))
    assert not tt.run_equirect_throughput(**size, **kw)["equal"]
