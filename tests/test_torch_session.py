"""The port's Session (blinky_tpu_torch.api) against blinky_tpu's, with
tests/test_session.py as the model: the same command script into both
Sessions gives bit-equal screens and the same console output (tolerance 0:
the screens are integers).  The float32 device builder behind a rotated
view is held to the JAX Session's by the builder's boundary tolerance (0.15
of the pixels at 64x48, tests/test_lensmap_parity.py:96).  What the port does
not have yet (the sharded render) raises."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blinky_tpu.api import Session as JSession
from blinky_tpu.kernels.remap import expand_frames_tinted as jexpand
from blinky_tpu.kernels.remap import frames_to_rgba as jrgba
import blinky_tpu_torch
from blinky_tpu_torch import api
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.kernels.remap import expand_frames_tinted, frames_to_rgba

REPO = Path(__file__).resolve().parents[1]

SCRIPTS = {
    "defaults": [],
    "rubix": ["f_rubix"],
    "fov120": ["f_fov 120"],
    "vfov90": ["f_vfov 90"],
    "tetra": ["f_globe tetra"],
    "cube_edge_rubixgrid": ["f_globe cube_edge", "f_rubix", "f_rubixgrid 5 3 2"],
    "trism_fov150": ["f_globe trism; f_fov 150"],
    "fast": ["f_globe fast"],
    "cube_corner": ["f_globe cube_corner; f_rubix"],
    "alias_echo": ['alias z "f_fov 100"', "z", "echo hi  there", "wait", "impulse 3",
                   "alias", 'alias combo "f_globe tetra; f_vfov 70"', "combo"],
    "bad_lens": ["f_lens nosuch"],
    "bad_globe": ["f_globe nosuch"],
    "cover": ["f_cover"],
    "contain": ["f_contain"],
    "fov_over_max": ["f_fov 400"],
    "queries": ["fisheye", "f_lens", "f_globe", "f_fov", "f_vfov", "f_rubixgrid",
                "f_help", "frobnicate"],
    "grid_zero": ["f_rubixgrid 0 0 0; f_rubix"],
    "relens": ["f_lens panini; f_fov 90; fisheye 2abc"],
}


def _pair(script, **kw):
    j = JSession(64, 48, backend="numpy", **kw)
    p = Session(64, 48, device="cpu", **kw)
    for line in script:
        j.cmd(line)
        p.cmd(line)
    return j, p


def _frames(B, size=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (6, size, size) + ((B,) if B else ()),
                        dtype=np.uint8)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_same_script_same_screens(name):
    j, p = _pair(SCRIPTS[name])
    frames = _frames(3, seed=len(name))
    _same(p.render(frames), j.render(frames))
    _same(p.render(frames, decode_rgb=True), j.render(frames, decode_rgb=True))
    _same(p.render(frames_to_rgba(frames, p.palette)),
          j.render(jrgba(frames, j.palette)))
    _same(p.render(expand_frames_tinted(frames, p.palette), rubix=True),
          j.render(jexpand(frames, j.palette), rubix=True))
    _same(p.render_host(frames[..., 1]), j.render_host(frames[..., 1]))
    _same(p.render(frames[..., 2]), j.render(frames[..., 2]))
    assert p.console == j.console
    for f in ("lens_name", "globe_name", "lens_valid", "globe_valid",
              "fisheye_enabled", "rubix_enabled", "rubix_numcells",
              "rubix_cell_size", "rubix_pad_size", "aliases"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.zoom.command() == j.zoom.command()
    if j.lensmap is None:
        assert p.lensmap is None
    else:
        for f in ("plate", "valid", "tint", "flat_idx", "plates_used"):
            np.testing.assert_array_equal(getattr(p.lensmap, f),
                                          getattr(j.lensmap, f), err_msg=f)


def test_background_size_and_palette():
    j, p = _pair(["f_globe fast"])  # two plates: unmapped pixels show
    rng = np.random.default_rng(1)
    bg = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    j.set_background(bg)
    p.set_background(bg)
    frames = _frames(2, seed=2)
    assert (~p.lensmap.valid).any()
    _same(p.render(frames, rubix=True), j.render(frames, rubix=True))
    _same(p.render(frames_to_rgba(frames, p.palette)),
          j.render(jrgba(frames, j.palette)))
    pal = p.palette[::-1].copy()
    j.palette = pal
    p.palette = pal
    _same(p.render(frames, decode_rgb=True), j.render(frames, decode_rgb=True))
    for s in (j, p):
        s.set_size(61, 37)
    small = _frames(2, size=37, seed=3)
    _same(p.render(small), j.render(small))
    # frames of another plate size rebuild the table at that size
    _same(p.render(_frames(2, size=40)), j.render(_frames(2, size=40)))
    assert p.console == j.console


def test_defaults_mirror_f_init():
    sess = Session(64, 48, device="cpu")
    assert sess.fisheye_enabled and sess.device == torch.device("cpu")
    assert (sess.globe_name, sess.lens_name) == ("cube", "panini")
    assert sess.zoom.command() == "f_fov 180"
    assert (sess.rubix_numcells, sess.rubix_cell_size, sess.rubix_pad_size) == (10, 4.0, 1.0)
    assert blinky_tpu_torch.device("cpu") == torch.device("cpu")
    assert blinky_tpu_torch.Session is Session
    s2 = Session(64, 48, device="cpu", defaults=False)
    assert not s2.fisheye_enabled and s2.lensmap is None


def test_unported_surface_raises():
    """Every console command and every public method of blinky_tpu's
    Session is the port's too (the sharded render came with the multi-GPU
    slice); nothing is left to raise NotImplementedError."""
    j = JSession(64, 48, backend="numpy")
    p = Session(64, 48, device="cpu")
    assert not hasattr(api, "_UNPORTED_COMMANDS")
    assert not hasattr(api, "_UNPORTED_METHODS")
    assert sorted(p._commands) == sorted(j._commands)
    for name in sorted(n for n in dir(JSession) if not n.startswith("_")):
        assert hasattr(Session, name), name
    for name in ("press_key", "build_progress"):
        assert hasattr(p, name), name
    assert p.build_progress is None
    with pytest.raises(AttributeError):
        p.no_such_attribute
    # every lens of blinky_tpu loads and renders as there (the last twelve
    # came with the forward rasterizer); an unknown name is not a valid lens
    for line in ("f_lens quincuncial", "f_lens eckert1", "f_lens nosuch"):
        p.cmd(line)
        j.cmd(line)
        assert (p.lens_name, p.lens_valid) == (j.lens_name, j.lens_valid), line
        _same(p.render(_frames(1)), j.render(_frames(1)))
    assert p.console == j.console
    # fisheye 0 renders the plain view, and time-sliced builds are taken
    for s in (j, p):
        s.cmd("fisheye 0")
    _same(p.render(_frames(1)), j.render(_frames(1)))
    sliced = Session(64, 48, device="cpu", build_budget_s=0.01, cmdline_cmds=["f_fov 90"])
    assert sliced.build_budget_s == 0.01 and sliced.cmdline_cmds == ["f_fov 90"]
    # the card unless the caller asks for the CPU; nothing is allocated
    # until a render, so this needs no card
    assert Session(64, 48).device == torch.device("cuda")


def test_port_imports_without_jax():
    """blinky_tpu_torch never imports jax or blinky_tpu: with jax made
    unimportable, the whole slice imports and renders."""
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
import blinky_tpu_torch
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench import sol, throughput
from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
from blinky_tpu_torch.kernels import _build, posed, remap, static_ray
from blinky_tpu_torch.bench import autobatch
from blinky_tpu_torch import budget, camera
s = Session(64, 48, device="cpu")
frames = synthetic_cubemap_batch(48, 2)
out = s.render(frames)
assert out.shape == (48, 64, 2)
out = s.render_posed(frames, np.array([(0.0, 0.0, 0.0), (10.0, 20.0, 5.0)]))
assert out.shape == (2, 48, 64) and out.device.type == "cpu"
out = s.render_posed(frames, np.zeros((2, 3)), exact=True, render_scale=2)
assert out.shape == (2, 48, 64)
bad = [m for m, mod in sys.modules.items()
       if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "blinky_tpu")]
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_mesh_cli_viewer_and_examples_import_without_jax():
    """The multi-GPU slice's modules (parallel, cli, viewer, the examples)
    import and run with jax made unimportable, and pull in neither jax nor
    blinky_tpu."""
    code = """
import sys, io, contextlib, importlib.util, pathlib
sys.modules["jax"] = None
import numpy as np, torch
from blinky_tpu_torch import cli, parallel, viewer
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
for p in sorted(pathlib.Path("blinky_tpu_torch/examples").glob("*.py")):
    spec = importlib.util.spec_from_file_location("ex_" + p.stem.replace("3", "x3"), p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
s = Session(64, 48, platesize=32, device="cpu")
mesh = parallel.make_mesh(4, 2, devices=[torch.device("cpu")] * 8)
frames = synthetic_cubemap_batch(32, 8)
assert np.array_equal(np.asarray(s.render_sharded(frames, mesh)), s.render(frames).numpy())
with contextlib.redirect_stdout(io.StringIO()):
    assert cli.main(["lenses", "--device", "cpu"]) == 0
v = viewer.Viewer(s, frames[..., 0])
v.start()
v.stop()
bad = [m for m, mod in sys.modules.items()
       if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "blinky_tpu")]
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# ------------------------------------- the backend policy and setviewangles


def _flat_idx_share(p, j):
    return float((np.asarray(p.lensmap.flat_idx) != np.asarray(j.lensmap.flat_idx)).mean())


def test_backend_policy():
    """``backend="auto"``: a static view builds on the exact host builder, a
    rotated one (setviewangles) on the float32 builder on the device;
    "numpy" and "torch" force one path (blinky_tpu/api.py:316-322, with
    "torch" where the JAX Session says "jax")."""
    j = JSession(64, 48, backend="auto")
    p = Session(64, 48, device="cpu")
    assert p.backend == "auto" and p.view_angles is None
    assert (p._resolved_backend(), j._resolved_backend()) == ("numpy", "numpy")
    assert p._view_basis() is None
    assert isinstance(p.lensmap.flat_idx, np.ndarray)
    for s in (j, p):
        s.cmd("setviewangles 10 30 5")
    assert p.view_angles == j.view_angles == (10.0, 30.0, 5.0)
    assert (p._resolved_backend(), j._resolved_backend()) == ("torch", "jax")
    for a, b in zip(p._view_basis(), j._view_basis()):
        np.testing.assert_array_equal(a, b)
    lm = p.lensmap
    assert isinstance(lm.flat_idx, np.ndarray)  # Session.lensmap hands out NumPy
    assert isinstance(p._lensmap.flat_idx, torch.Tensor)  # the build stays on the device
    assert p.lensmap is lm  # copied out once a build
    # the float32 builds of the two packages, within the builder's tolerance
    assert _flat_idx_share(p, j) <= 0.15
    assert p._lensmap_meta[2] is False and j._lensmap_meta[2] is False
    for s in (j, p):
        s.cmd("setviewangles")
    assert p.view_angles is None and p._resolved_backend() == "numpy"
    np.testing.assert_array_equal(p.lensmap.flat_idx, np.asarray(j.lensmap.flat_idx))
    assert p._lensmap_meta[2] is True
    forced = Session(64, 48, device="cpu", backend="torch")
    assert forced._resolved_backend() == "torch"
    assert isinstance(forced.lensmap.flat_idx, np.ndarray)
    assert isinstance(forced._lensmap.flat_idx, torch.Tensor)
    host = Session(64, 48, device="cpu", backend="numpy")
    host.cmd("setviewangles 10 30 5")
    assert host._resolved_backend() == "numpy"
    jhost = JSession(64, 48, backend="numpy")
    jhost.cmd("setviewangles 10 30 5")
    np.testing.assert_array_equal(host.lensmap.flat_idx, np.asarray(jhost.lensmap.flat_idx))
    with pytest.raises(ValueError, match="backend"):
        Session(64, 48, device="cpu", backend="jax")


@pytest.mark.parametrize("script", [["setviewangles 10 30 0"],
                                    ["f_globe tetra", "setviewangles -20 200 15", "f_rubix"],
                                    ["setviewangles 5 5 5", "setviewangles"],
                                    ["setviewangles 1 2"]],
                         ids=["yawed", "tetra-rubix", "reset", "too-few-args"])
def test_setviewangles_renders(script):
    """setviewangles with and without arguments: the same script in both
    Sessions under the exact host builder gives bit-equal screens; under
    "auto" the rotated view takes each package's float32 builder, whose
    screens agree but for the boundary texels the builders differ at."""
    jn, pn = _pair(script)  # backend="numpy" on the JAX side, forced below
    pn.backend = "numpy"
    pn._changed = True
    frames = _frames(3, seed=4)
    _same(pn.render(frames), jn.render(frames))
    _same(pn.render_host(frames[..., 0]), jn.render_host(frames[..., 0]))
    assert pn.console == jn.console and pn.view_angles == jn.view_angles
    ja = JSession(64, 48, backend="auto")
    pa = Session(64, 48, device="cpu")
    for line in script:
        ja.cmd(line)
        pa.cmd(line)
    got, want = pa.render(frames).numpy(), np.asarray(ja.render(frames))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float((got != want).mean()) <= 0.15
    if pa.view_angles is None:
        np.testing.assert_array_equal(got, want)
    # rubix and decode ride the device-built table like the host-built one
    _same(pa.render(frames, rubix=True)[..., 1],
          torch.from_numpy(np.asarray(pa.render_host(frames[..., 1], rubix=True)))
          if pa.view_angles is None else pa.render(frames[..., 1], rubix=True))


def test_device_built_lensmap_feeds_every_source_kind():
    """A float32 build's tables stay tensors; the remap takes them for every
    source kind and equals host_remap of the same table copied out."""
    from blinky_tpu_torch.kernels.remap import (
        expand_frames_tinted_rgba, host_remap,
    )

    p = Session(64, 48, device="cpu", backend="torch")
    p.cmd("f_globe fast; setviewangles 3 -40 10")
    bg = np.random.default_rng(5).integers(0, 256, (48, 64), dtype=np.uint8)
    p.set_background(bg)
    frames = _frames(2, seed=6)
    lm = p.lensmap
    rgba = frames_to_rgba(frames, p.palette)
    cases = [(frames, {}), (frames, dict(rubix=True)), (frames, dict(decode_rgb=True)),
             (expand_frames_tinted(frames, p.palette), dict(rubix=True)),
             (rgba, {}), (rgba, dict(rubix=True)),
             (expand_frames_tinted_rgba(rgba), dict(rubix=True))]
    for fr, kw in cases:
        out = p.render(fr, **kw)
        got = out.view(torch.int32).numpy().view(np.uint32) if out.dtype == torch.uint32 \
            else out.numpy()
        for b in range(2):
            want = host_remap(lm, fr[..., b], p.palette, bg, **kw)
            np.testing.assert_array_equal(got[:, :, b] if got.ndim == 3 or kw.get("decode_rgb")
                                          else got[..., b], want)
    # render_host forces the host builder, even for a rotated view
    exact = Session(64, 48, device="cpu", backend="numpy")
    exact.cmd("f_globe fast; setviewangles 3 -40 10")
    exact.set_background(bg)
    fresh = Session(64, 48, device="cpu", backend="torch")
    fresh.cmd("f_globe fast; setviewangles 3 -40 10")
    fresh.set_background(bg)
    _same(fresh.render_host(frames[..., 0]), exact.render_host(frames[..., 0]))
    assert fresh.backend == "torch"


def test_warm_device_builder():
    from blinky_tpu_torch.lensmap import device_builder_warm

    j = JSession(64, 48, backend="auto")
    p = Session(60, 44, device="cpu")
    assert not device_builder_warm(p.lens, p.globe, 60, 44, p.platesize, device="cpu")
    assert p.warm_device_builder() is True and j.warm_device_builder() is True
    assert device_builder_warm(p.lens, p.globe, 60, 44, p.platesize, device="cpu")
    assert p._lensmap is None or isinstance(p._lensmap.flat_idx, np.ndarray)  # not installed
    p.cmd("f_fov 400")  # over max_fov: any scale warms the builder
    assert p.warm_device_builder() is True
    for s in (j, p):
        s.cmd("f_lens nosuch")
    assert p.warm_device_builder() is False and j.warm_device_builder() is False
    empty = Session(64, 48, device="cpu", defaults=False)
    assert empty.warm_device_builder() is False


def test_posed_table_reuse_needs_an_identity_view_build():
    """_lensmap_meta's third field: a static lensmap with a view rotation
    composed in is no seed for a posed ray table (blinky_tpu/api.py:1415)."""
    p = Session(64, 48, device="cpu")
    p.lensmap
    scale = p.lensmap.scale
    assert p._reusable_static_lensmap(scale, p.platesize, 1) is p._lensmap
    p.cmd("setviewangles 10 0 0")
    assert p._reusable_static_lensmap(scale, p.platesize, 1) is p._lensmap  # built before
    p.lensmap
    assert p._reusable_static_lensmap(scale, p.platesize, 1) is None


# ---------------------------------------------------------------- the 360-video path
# and the supersampled render: tolerance 0, as the JAX package pins its own
# three formulations to each other (tests/test_equirect_fused.py).

EQ = dict(pano=(32, 64), screen=(48, 36), platesize=24)


def _equirect_pair(script=()):
    W, H = EQ["screen"]
    j = JSession(W, H, platesize=EQ["platesize"], backend="numpy")
    p = Session(W, H, platesize=EQ["platesize"], device="cpu")
    for line in script:
        j.cmd(line)
        p.cmd(line)
    return j, p


def _eq_panos(B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, EQ["pano"] + (B,), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("mode", ["compact", "fused", "faces"])
@pytest.mark.parametrize("script", [(), ("f_rubix",), ("f_lens hammer", "f_contain"),
                                    ("f_globe tetra", "f_rubix")],
                         ids=["defaults", "rubix", "hammer_contain", "tetra_rubix"])
def test_render_equirect_equals_jax(mode, script):
    """A batch, one [H, W] u32 pano and one [H, W, 3] u8 RGB pano, bilinear
    and nearest, against blinky_tpu's Session; the three modes bit-equal."""
    j, p = _equirect_pair(script)
    panos = _eq_panos(3, seed=len(script))
    for bilinear in (True, False):
        want = np.asarray(j.render_equirect(panos, bilinear=bilinear, mode=mode))
        got = p.render_equirect(panos, bilinear=bilinear, mode=mode)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.uint32
        _same(got, want)
        _same(p.render_equirect(panos, bilinear=bilinear), want)  # compact, the default
        _same(p.render_equirect(torch.from_numpy(panos), bilinear=bilinear, mode=mode), want)
    one = panos[..., 1]
    _same(p.render_equirect(one, mode=mode), j.render_equirect(one, mode=mode))
    _same(p.render_equirect(torch.from_numpy(one), mode=mode),
          j.render_equirect(one, mode=mode))
    rgb = np.random.default_rng(8).integers(0, 256, EQ["pano"] + (3,), np.uint8)
    got = p.render_equirect(rgb, mode=mode)
    assert tuple(got.shape) == (EQ["screen"][1], EQ["screen"][0])
    _same(got, j.render_equirect(rgb, mode=mode))


def test_render_equirect_state_changes_and_fallbacks():
    j, p = _equirect_pair()
    panos = _eq_panos(2, seed=3)
    base = p.render_equirect(panos)
    with pytest.raises(ValueError, match="compact|fused|faces"):
        p.render_equirect(panos, mode="bogus")
    for cmd in ("f_rubix", "f_rubix", "f_lens stereographic", "f_fov 120"):
        j.cmd(cmd)
        p.cmd(cmd)
        for mode in ("compact", "fused", "faces"):
            _same(p.render_equirect(panos, mode=mode), j.render_equirect(panos, mode=mode))
    assert not torch.equal(p.render_equirect(panos).view(torch.int32),
                           base.view(torch.int32))
    # a u8 background shows decoded where the lens leaves gaps
    bg = np.full((EQ["screen"][1], EQ["screen"][0]), 251, np.uint8)
    for s in (j, p):
        s.cmd("f_lens fisheye1; f_contain")
        s.set_background(bg)
    for mode in ("compact", "fused", "faces"):
        _same(p.render_equirect(panos, mode=mode), j.render_equirect(panos, mode=mode))
    # an invalid lens: every mode steps aside to the decoded background
    for s in (j, p):
        s.cmd("f_lens nosuch")
    for mode in ("compact", "fused", "faces"):
        got = p.render_equirect(panos, mode=mode)
        assert got.dtype == torch.uint32
        _same(got, j.render_equirect(panos, mode=mode))
    # fisheye 0: every mode steps aside to the faces' plain view
    for s in (j, p):
        s.cmd("f_lens panini; fisheye 0")
    for mode in ("compact", "fused", "faces"):
        got = p.render_equirect(panos, mode=mode)
        assert got.dtype == torch.uint32
        _same(got, j.render_equirect(panos, mode=mode))


def test_render_equirect_alternating_modes_keep_both_chains(monkeypatch):
    """The composed-chain cache is a dict validated by RemapKernel identity:
    alternating modes builds each chain once; a lens switch drops both."""
    import blinky_tpu_torch.kernels.ingest as ing

    _, p = _equirect_pair()
    panos = _eq_panos(2, seed=5)
    builds = []
    for name in ("CompactEquirectChain", "EquirectScreenKernel"):
        orig = getattr(ing, name)

        def counted(*a, _o=orig, _n=name, **k):
            builds.append(_n)
            return _o(*a, **k)

        monkeypatch.setattr(ing, name, counted)
    a = p.render_equirect(panos)
    _same(p.render_equirect(panos, mode="fused"), a.numpy())
    assert builds == ["CompactEquirectChain", "EquirectScreenKernel"]
    _same(p.render_equirect(panos), a.numpy())
    _same(p.render_equirect(panos, mode="faces"), a.numpy())
    _same(p.render_equirect(panos, mode="fused"), a.numpy())
    assert len(builds) == 2
    ingest_before = p._equirect_cache[1]
    p.cmd("f_lens stereographic")
    p.render_equirect(panos)
    assert builds[-1] == "CompactEquirectChain" and len(builds) == 3
    assert len(p._equirect_fused) == 1  # the stale generation is evicted
    assert p._equirect_cache[1] is ingest_before  # the ingest does not depend on the lens
    p.render_equirect(panos, bilinear=False)
    assert p._equirect_cache[1] is not ingest_before


@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("source", ["u8", "u32", "expanded_u8", "expanded_u32", "batch"])
def test_render_aa_equals_jax(factor, source):
    from blinky_tpu.kernels.remap import expand_frames_tinted_rgba as jexpand_rgba
    from blinky_tpu_torch.kernels.remap import expand_frames_tinted_rgba

    j = JSession(64, 48, platesize=32, backend="numpy")
    p = Session(64, 48, platesize=32, device="cpu")
    for s in (j, p):
        s.cmd("f_lens fisheye1; f_contain")  # a circular boundary: aliasing
    frames = _frames(3 if source == "batch" else 0, size=32, seed=factor)
    rubix = source.startswith("expanded")
    if source == "u32":
        jf, pf = jrgba(frames, j.palette), frames_to_rgba(frames, p.palette)
    elif source == "expanded_u8":
        jf, pf = jexpand(frames, j.palette), expand_frames_tinted(frames, p.palette)
    elif source == "expanded_u32":
        jf = jexpand_rgba(jrgba(frames, j.palette))
        pf = expand_frames_tinted_rgba(frames_to_rgba(frames, p.palette))
    else:
        jf = pf = frames
    if rubix:
        for s in (j, p):
            s.cmd("f_rubix")
    want = np.asarray(j.render_aa(jf, factor=factor))
    got = p.render_aa(pf, factor=factor)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint32
    _same(got, want)
    _same(p.render_aa(torch.from_numpy(pf), factor=factor), want)  # frames as a tensor
    if factor == 1 and not rubix:
        _same(got, p.render(frames_to_rgba(frames, p.palette)))


def test_render_aa_errors_background_and_cache():
    j = JSession(32, 24, platesize=16, backend="numpy")
    p = Session(32, 24, platesize=16, device="cpu")
    frames = _frames(0, size=16, seed=2)
    with pytest.raises(ValueError, match="factor"):
        p.render_aa(frames, factor=0)
    p.cmd("f_rubix")
    with pytest.raises(ValueError, match="expanded"):
        p.render_aa(frames, factor=2)
    p.cmd("f_rubix")
    # a background shows through where the lens leaves gaps
    bg = np.full((24, 32), 251, np.uint8)
    for s in (j, p):
        s.cmd("f_lens fisheye1; f_contain")
        s.set_background(bg)
    aa = p.render_aa(frames, factor=2)
    _same(aa, j.render_aa(frames, factor=2))
    assert int(aa.view(torch.int32)[0, 0]) == int(
        frames_to_rgba(bg, p.palette).view(np.int32)[0, 0])
    # alternating factors both stay cached; a lens switch makes a new entry
    p.render_aa(frames, factor=1)
    cache = p._aa_cache
    n = len(cache)
    assert n >= 2
    hi = next(iter(cache.values()))
    p.render_aa(frames, factor=2)
    assert len(p._aa_cache) == n and next(iter(p._aa_cache.values())) is hi
    for s in (j, p):
        s.cmd("f_lens hammer")
    _same(p.render_aa(frames, factor=2), j.render_aa(frames, factor=2))
    assert len(p._aa_cache) == n + 1
    for f in (3, 4, 6):  # never more than four hi-res sessions
        p.render_aa(frames, factor=f)
    assert len(p._aa_cache) <= 4
    # a view rotation is mirrored (the float32 device builder on both sides
    # of the port: held to itself), and a palette change flushes the cache
    p.cmd("setviewangles 10 30 0")
    rot = p.render_aa(frames, factor=2)
    assert not torch.equal(rot.view(torch.int32), aa.view(torch.int32))
    pal2 = p.palette.copy()
    pal2[251] = (0, 255, 0)
    p.palette = pal2
    j.palette = pal2
    assert p._aa_cache is None
    p.cmd("setviewangles")
    _same(p.render_aa(frames, factor=2), j.render_aa(frames, factor=2))
    # an invalid lens: the decoded background, box-averaged
    for s in (j, p):
        s.cmd("f_lens nosuch")
    _same(p.render_aa(frames, factor=2), j.render_aa(frames, factor=2))


@pytest.mark.parametrize("chunk", [1, 7, 1 << 26])
def test_palette_decode_in_pieces_and_cached(monkeypatch, chunk):
    """The decode of a u8 tensor to packed RGBA, whatever the piece size, is
    the host's ``frames_to_rgba``; the LUT is uploaded once a palette."""
    monkeypatch.setattr(api, "_DECODE_CHUNK", chunk)
    p = Session(32, 24, platesize=16, device="cpu")
    frames = _frames(3, size=5, seed=4)
    got = p._rgba_screen(torch.from_numpy(frames))
    assert got.dtype == torch.uint32 and got.shape == frames.shape
    _same(got, frames_to_rgba(frames, p.palette))
    lut = p._rgba_lut
    _same(p._rgba_screen(torch.from_numpy(frames[..., 1])),  # not contiguous
          frames_to_rgba(frames[..., 1], p.palette))
    assert p._rgba_lut is lut
    assert p._rgba_screen(got) is got  # packed RGBA passes
    pal2 = p.palette.copy()
    pal2[:, 0] = 255 - pal2[:, 0]
    p.palette = pal2
    assert p._rgba_lut is None
    _same(p._rgba_screen(torch.from_numpy(frames)), frames_to_rgba(frames, pal2))


@pytest.mark.parametrize("script", [
    [], ["f_rubixgrid 5 3 2", "f_globe tetra", "f_vfov 70"],
    ["f_lens stereographic", "f_fov 200", 'alias z "f_fov 100"'],
    ["f_lens stereographic", "f_cover"],
    ["f_lens hammer", "f_contain", "fisheye 0"],
], ids=["defaults", "grid_tetra_vfov", "stereo_fov_alias", "stereo_cover", "hammer_contain_off"])
def test_config_str_replays_into_a_fresh_session(script, tmp_path):
    """config_str replayed into a bare Session gives the same state and an
    equal lensmap; its lines are blinky_tpu's, binds and fov cvar included."""
    j, p = _pair(script)
    assert p.config_str() == j.config_str()
    fresh = Session(64, 48, device="cpu", defaults=False)
    for line in p.config_str().splitlines():
        fresh.cmd(line)
    p.write_config(tmp_path / "config.cfg")
    filed = Session(64, 48, device="cpu", defaults=False)
    filed.exec_config(tmp_path / "config.cfg")
    for s in (fresh, filed):
        assert s.config_str() == p.config_str()
        assert s.aliases == p.aliases and s.fisheye_enabled == p.fisheye_enabled
        a, b = s.lensmap, p.lensmap
        assert (a is None) == (b is None)  # a zoom the lens cannot solve
        for f in ("flat_idx", "valid", "tint", "plates_used") if b is not None else ():
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
