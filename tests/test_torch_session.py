"""The port's Session (blinky_tpu_torch.api) against blinky_tpu's, with
tests/test_session.py as the model: the same command script into both
Sessions gives bit-equal screens and the same console output (tolerance 0:
the screens are integers).  What the port does not have yet raises."""

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
    with pytest.raises(NotImplementedError, match="hammer"):
        p.cmd("f_lens hammer")
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
