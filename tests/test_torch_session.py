"""The port's Session (blinky_tpu_torch.api) against blinky_tpu's, with
tests/test_session.py as the model: the same command script into both
Sessions gives bit-equal screens and the same console output (tolerance 0:
the screens are integers).  The float32 device builder behind a rotated
view is held to the JAX Session's by the builder's boundary tolerance (0.15
of the pixels at 64x48, tests/test_lensmap_parity.py:96).  What the port does
not have yet raises."""

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
    j = JSession(64, 48, backend="numpy")
    p = Session(64, 48, device="cpu")
    for name in sorted(api._UNPORTED_COMMANDS):
        assert name in j._commands, name
        with pytest.raises(NotImplementedError, match=name):
            p.cmd(f"{name} 1")
    for name in sorted(api._UNPORTED_METHODS):
        assert hasattr(JSession, name), name
        with pytest.raises(NotImplementedError, match=name):
            getattr(p, name)
    with pytest.raises(AttributeError):
        p.no_such_attribute
    # a lens blinky_tpu has but the port lacks is not "not a valid lens"
    with pytest.raises(NotImplementedError, match="quincuncial"):
        p.cmd("f_lens quincuncial")
    p.cmd("fisheye 0")
    with pytest.raises(NotImplementedError, match="fisheye 0"):
        p.render(_frames(1))
    with pytest.raises(NotImplementedError):
        Session(64, 48, device="cpu", lens_dirs=[REPO])
    with pytest.raises(NotImplementedError):
        Session(64, 48, device="cpu", build_budget_s=0.01)
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
from blinky_tpu_torch import camera
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
