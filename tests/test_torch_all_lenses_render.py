"""Every built-in lens renders through the port's Session as through
blinky_tpu's: tests/test_all_lenses_render.py's ``f_lens <tab>`` sweep, held
bit for bit (tolerance 0: the screens are integers) against
``blinky_tpu.api.Session(backend="numpy")`` at 64x48, plain and rubix, and
for a forward-only lens also under ``backend="torch"`` and after
``setviewangles`` (the host rasterizer with the view basis composed in)."""

import numpy as np
import pytest
import torch

from blinky_tpu.api import Session as JSession
from blinky_tpu.io.cubemap import synthetic_cubemap as jsynthetic
from blinky_tpu_torch import lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.kernels.remap import expand_frames_tinted

FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _check(p, j, frames):
    assert p.lens_valid and j.lens_valid
    _same(p.render(frames), j.render(frames))
    _same(p.render(frames, rubix=True), j.render(frames, rubix=True))
    _same(p.render(expand_frames_tinted(frames, p.palette), rubix=True),
          j.render(np.asarray(expand_frames_tinted(frames, p.palette)), rubix=True))
    for f in FIELDS:
        _same(getattr(p.lensmap, f), getattr(j.lensmap, f))
    assert p.console == j.console


@pytest.mark.parametrize("lens_name", lenses.names())
def test_lens_renders_through_session(lens_name):
    frames = synthetic_cubemap(48)
    np.testing.assert_array_equal(frames, jsynthetic(48))
    p = Session(64, 48, device="cpu")
    j = JSession(64, 48, backend="numpy")
    for s in (p, j):
        s.cmd(f"f_lens {lens_name}")
    out = p.render(frames)
    assert out.shape == (48, 64) and out.numpy().any(), lens_name
    assert p.lensmap.valid.any(), lens_name
    _check(p, j, frames)


@pytest.mark.parametrize("script", [["f_lens eckert1"],
                                    ["f_lens polyconic", "f_globe tetra", "f_rubix"],
                                    ["f_lens gins8", "setviewangles 10 30 0"]])
def test_forward_lens_under_backend_torch(script):
    """backend="torch" takes the host rasterizer for a forward lens (NumPy
    tables, uploaded by RemapKernel), with the view basis when one is set,
    and renders what the JAX package's exact Session renders."""
    frames = np.stack([synthetic_cubemap(48)] * 2, axis=-1)
    p = Session(64, 48, device="cpu", backend="torch")
    j = JSession(64, 48, backend="numpy")
    for line in script:
        p.cmd(line)
        j.cmd(line)
    _check(p, j, frames)
    assert isinstance(p._lensmap.flat_idx, np.ndarray)
    # what the table was built from: the view composed in or not
    assert p._lensmap_meta[2] == (p.view_angles is None)


@pytest.mark.parametrize("lens_name", ["eckert1", "winkel2", "larrivee"])
def test_forward_lens_after_setviewangles(lens_name):
    """Under "auto" a rotated view of a forward lens rasterizes on the host
    with the view basis (there is no float32 builder to take it): the screen
    equals the JAX package's, the rotation moves the table, and resetting the
    view gives the static table back."""
    frames = synthetic_cubemap(48)
    p = Session(64, 48, device="cpu")
    j = JSession(64, 48, backend="numpy")
    for s in (p, j):
        s.cmd(f"f_lens {lens_name}")
    static = p.lensmap.flat_idx.copy()
    for s in (p, j):
        s.cmd("setviewangles 10 30 0")
    assert p._resolved_backend() == "torch"
    _check(p, j, frames)
    assert (p.lensmap.flat_idx != static).mean() > 0.3
    assert not p._lensmap_meta[2]
    for s in (p, j):
        s.cmd("setviewangles")
    _check(p, j, frames)
    np.testing.assert_array_equal(p.lensmap.flat_idx, static)
