"""The port's built-in lenses (blinky_tpu_torch.lenses) against blinky_tpu's.

For each ported lens, at the JAX tests' small size (64x48 screen, 48-pixel
plates) and at the lens's own ``onload`` zoom:

* the metadata and the zoom scale equal blinky_tpu's exactly;
* the NumPy float64 build equals blinky_tpu's bit for bit (tolerance 0), and
  the golden tables and screens of ``tests/goldens/*.npz`` where one exists;
* the float32 build on tensors lies within the reference's own tolerance for
  float32 noise (tests/test_lensmap_parity.py:78-102) of the JAX float32
  builder: ``flat_idx`` differs on at most 0.15 of the pixels at this size,
  where texel boundaries dominate, and where both are valid and chose the
  same plate, ``px`` and ``py`` lie within one texel.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.kernels.remap import RemapKernel, expand_frames_tinted
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.palette import default_palette

W, H, S = 64, 48, 48
FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
F32_SHARE = 0.15
GOLDENS = {p.stem.split("__")[0]: p
           for p in sorted(Path(__file__).parent.glob("goldens/*.npz"))}
# the 18 lenses of this slice (panini came with the first)
LENSES = [n for n in lenses.BUILTIN_LENSES if n != "panini"]


def _zoom(onload):
    """A lens's onload command as zoom arguments: "f_fov 180" -> ("fov", 180)."""
    words = (onload or "f_fov 180").split()
    return (words[0][2:],) + tuple(int(w) for w in words[1:])


def _pair(name, globe_name="cube"):
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    jl, lens = jlenses.get(name, jg), lenses.get(name, g)
    z = _zoom(lens.onload)
    jscale = jcalc(JZoom(*z), jl, W, H)
    scale = calc_scale(Zoom(*z), lens, W, H)
    return jg, jl, jscale, g, lens, scale


def test_the_slice_ports_the_18_lenses():
    assert len(LENSES) == 18
    assert sorted(lenses.BUILTIN_LENSES + lenses.UNPORTED_LENSES) == sorted(
        jlenses.BUILTIN_LENSES)
    assert lenses.names() == lenses.BUILTIN_LENSES


@pytest.mark.parametrize("name", LENSES)
def test_lens_metadata_and_scale_equal(name):
    _, jl, jscale, _, lens, scale = _pair(name)
    for f in ("name", "map_type", "width", "height", "max_fov", "max_vfov", "onload"):
        assert getattr(lens, f) == getattr(jl, f), f
    assert lens.map_type == "inverse"
    assert scale == jscale
    for z in (("fov", 90), ("vfov", 60), ("fov", 160)):  # NaN where the JAX solve gives NaN
        np.testing.assert_array_equal(calc_scale(Zoom(*z), lens, W, H),
                                      jcalc(JZoom(*z), jl, W, H), err_msg=str(z))


@pytest.mark.parametrize("globe_name", ["cube", "tetra"])
@pytest.mark.parametrize("name", LENSES)
def test_numpy_build_bit_equals_jax(name, globe_name):
    jg, jl, jscale, g, lens, scale = _pair(name, globe_name)
    want = jbuild(jl, jg, jscale, W, H, S, backend="numpy").to_numpy()
    got = build_lensmap(lens, g, scale, W, H, S)
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", sorted(set(GOLDENS) & set(LENSES)))
def test_numpy_build_matches_golden(name):
    path = GOLDENS[name]
    _, globe_name, zoomspec = path.stem.split("__")
    ztype = zoomspec.rstrip("0123456789")
    g = globes.get(globe_name)
    lens = lenses.get(name, g)
    with np.load(path) as z:
        gold = {k: z[k] for k in z.files}
    scale = calc_scale(Zoom(ztype, int(zoomspec[len(ztype):] or 0)), lens, W, H)
    assert scale == float(gold["scale"])
    lm = build_lensmap(lens, g, scale, W, H, S)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(lm, f), gold[f], err_msg=f)
    pal = default_palette()
    kernel = RemapKernel(lm, pal, device="cpu")
    frames = synthetic_cubemap(S)
    np.testing.assert_array_equal(kernel(frames).numpy(), gold["screen"])
    np.testing.assert_array_equal(
        kernel(expand_frames_tinted(frames, pal), rubix=True).numpy(), gold["rubix"])


def _within_f32_tolerance(got, want, what):
    share = float((got.flat_idx != want.flat_idx).mean())
    print(f"{what}: flat_idx differs on {share:.4f} of the pixels")
    assert share <= F32_SHARE, (what, share)
    same = got.valid & want.valid & (got.plate == want.plate)
    for f in ("px", "py"):
        d = np.abs(getattr(got, f) - getattr(want, f))[same]
        assert d.max(initial=0) <= 1, (what, f, int(d.max()))
    return share


@pytest.mark.parametrize("name", LENSES)
def test_f32_build_within_tolerance_of_jax_f32(name):
    """The float32 build on tensors against build_lensmap(backend="jax",
    dtype=float32), and both against the exact build (the port's float32
    drift is no larger than the JAX builder's plus the share the two differ
    by)."""
    jg, jl, jscale, g, lens, scale = _pair(name)
    got = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu").to_numpy()
    want = jbuild(jl, jg, jscale, W, H, S, backend="jax", dtype=jnp.float32).to_numpy()
    for f in FIELDS:
        assert getattr(got, f).dtype == np.asarray(getattr(want, f)).dtype, f
    _within_f32_tolerance(got, want, f"{name} against the JAX float32 build")
    # against the exact build only the boundary share is bounded: where a
    # lens folds the sphere (cube's cross, cubestereo's faces) an edge ray
    # lands a whole texel row away
    exact = build_lensmap(lens, g, scale, W, H, S)
    share = float((got.flat_idx != exact.flat_idx).mean())
    jshare = float((np.asarray(want.flat_idx) != exact.flat_idx).mean())
    print(f"{name}: {share:.4f} of the pixels differ from the exact build (JAX: {jshare:.4f})")
    assert share <= max(F32_SHARE, jshare + 0.03)


@pytest.mark.parametrize("name", ["fisheye1", "hammer", "winkeltripel", "cube"])
def test_f32_build_with_view_basis_and_fast_globe(name):
    from blinky_tpu_torch.camera import view_basis_from_angles

    vb = view_basis_from_angles(10.0, 30.0, 5.0)
    for globe_name in ("cube", "fast"):
        jg, jl, jscale, g, lens, scale = _pair(name, globe_name)
        got = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu",
                            view_basis=vb).to_numpy()
        want = jbuild(jl, jg, jscale, W, H, S, backend="jax", dtype=jnp.float32,
                      view_basis=vb).to_numpy()
        _within_f32_tolerance(got, want, f"{name} on {globe_name}, rotated")
