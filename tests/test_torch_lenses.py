"""The port's built-in lenses (blinky_tpu_torch.lenses) against blinky_tpu's.

For each of the 31 lenses, at the JAX tests' small size (64x48 screen,
48-pixel plates) and at the lens's own ``onload`` zoom:

* the metadata and the zoom scale equal blinky_tpu's exactly;
* the NumPy float64 build (for the ten forward-only lenses, the host
  rasterizer) equals blinky_tpu's bit for bit (tolerance 0), and the golden
  tables and screens of ``tests/goldens/*.npz`` where one exists;
* the float32 build on tensors of an inverse lens lies within the
  reference's own tolerance for float32 noise
  (tests/test_lensmap_parity.py:78-102) of the JAX float32 builder:
  ``flat_idx`` differs on at most 0.15 of the pixels at this size, where
  texel boundaries dominate, and where both are valid and chose the same
  plate, ``px`` and ``py`` lie within one texel.  The debug lens samples a
  texel edge exactly at a quarter or more of its pixels at this size, so
  against the exact build it is held to those pixels
  (:func:`test_f32_debug_build_differs_only_on_texel_edges`).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import ZoomError as JZoomError
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.kernels.remap import RemapKernel, expand_frames_tinted
from blinky_tpu_torch.lensmap import Zoom, ZoomError, build_lensmap, calc_scale
from blinky_tpu_torch.palette import default_palette

W, H, S = 64, 48, 48
FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
F32_SHARE = 0.15
GOLDENS = {p.stem.split("__")[0]: p
           for p in sorted(Path(__file__).parent.glob("goldens/*.npz"))}
# every lens but panini, which tests/test_torch_lensmap.py holds
LENSES = [n for n in lenses.BUILTIN_LENSES if n != "panini"]
# the ten forward-only lenses and the two that reach the array namespace
FORWARD = ["eckert1", "eckert5", "gins8", "kavrayskiy7", "larrivee", "polyconic",
           "sinusoidal", "wagner6", "winkel1", "winkel2"]
NEW_LENSES = sorted(FORWARD + ["debug", "quincuncial"])
# the lenses whose float32 build on tensors is held to the JAX float32 builder
F32_LENSES = [n for n in LENSES if n not in FORWARD and n != "debug"]


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
    """The 18 lenses of the device-builder slice and the 12 of the
    rasterizer's: with panini, all 31 of blinky_tpu's."""
    assert len(LENSES) == 30 and len(NEW_LENSES) == 12
    assert lenses.BUILTIN_LENSES == jlenses.BUILTIN_LENSES
    assert lenses.names() == lenses.BUILTIN_LENSES
    assert not hasattr(lenses, "UNPORTED_LENSES")


@pytest.mark.parametrize("name", LENSES)
def test_lens_metadata_and_scale_equal(name):
    _, jl, jscale, _, lens, scale = _pair(name)
    for f in ("name", "map_type", "width", "height", "max_fov", "max_vfov", "onload"):
        assert getattr(lens, f) == getattr(jl, f), f
    assert lens.map_type == ("forward" if name in FORWARD else "inverse")
    assert scale == jscale
    for z in (("fov", 90), ("vfov", 60), ("fov", 160)):  # NaN where the JAX solve gives NaN
        try:
            want = jcalc(JZoom(*z), jl, W, H)
        except JZoomError as e:  # a lens with no max_fov (quincuncial, debug)
            with pytest.raises(ZoomError, match=str(e)):
                calc_scale(Zoom(*z), lens, W, H)
            continue
        np.testing.assert_array_equal(calc_scale(Zoom(*z), lens, W, H), want,
                                      err_msg=str(z))


# every lens on two globes; the twelve lenses of the rasterizer's slice also
# on the other four (the fast globe's resolver owns the forward lenses' texels)
@pytest.mark.parametrize("name,globe_name", [
    (n, g) for n in LENSES for g in ("cube", "tetra")] + [
    (n, g) for n in NEW_LENSES for g in ("cube_edge", "cube_corner", "trism", "fast")])
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


@pytest.mark.parametrize("name", F32_LENSES)
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


@pytest.mark.parametrize("name", FORWARD)
def test_forward_lens_torch_backend_rasterizes_on_the_host(name):
    """A forward lens has no float32 builder: backend="torch" gives the host
    rasterization, NumPy tables bit-equal to the exact build and blinky_tpu's
    (which routes backend="jax" the same way)."""
    jg, jl, jscale, g, lens, scale = _pair(name)
    got = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu")
    exact = build_lensmap(lens, g, scale, W, H, S)
    want = jbuild(jl, jg, jscale, W, H, S, backend="jax", dtype=jnp.float32).to_numpy()
    for f in FIELDS:
        assert isinstance(getattr(got, f), np.ndarray), f
        np.testing.assert_array_equal(getattr(got, f), getattr(exact, f), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("globe_name", jglobes.names())
def test_f32_debug_build_differs_only_on_texel_edges(globe_name):
    """The debug lens's float32 build: within F32_SHARE of the JAX float32
    builder, and where it differs from the exact build the exact lens-plane
    point lies on a texel edge of its plate (u*S or v*S an integer, up to
    1e-9), where
    float32 rounding decides the texel.  At 64x48 those are 0.44 to 1.0 of
    the pixels (a pixel is 2.25 texels wide on the 6-plate globes)."""
    jg, jl, jscale, g, lens, scale = _pair("debug", globe_name)
    got = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu").to_numpy()
    want = jbuild(jl, jg, jscale, W, H, S, backend="jax", dtype=jnp.float32).to_numpy()
    _within_f32_tolerance(got, want, f"debug on {globe_name} against the JAX float32 build")
    exact = build_lensmap(lens, g, scale, W, H, S)
    # the exact lens-plane coordinates and the debug layout's fractions
    x = (np.arange(W) - W // 2) * scale
    y = -(np.arange(H) - H // 2) * scale
    X, Y = np.meshgrid(x, y)
    cols = {4: [2, 2], 5: [3, 2], 6: [3, 3]}.get(g.numplates, [g.numplates])
    ny = -Y + len(cols) / 2
    v = np.modf(ny)[0]
    nx = X + np.array(cols)[np.clip(np.trunc(ny).astype(int), 0, len(cols) - 1)] / 2
    u = np.modf(nx)[0]
    # on an edge up to the float64 rounding of the exact coordinates
    edge = (np.abs(u * S - np.round(u * S)) < 1e-9) | (np.abs(v * S - np.round(v * S)) < 1e-9)
    moved = got.flat_idx != exact.flat_idx
    print(f"debug on {globe_name}: {moved.mean():.4f} of the pixels differ from the exact "
          f"build, {edge.mean():.4f} sample a texel edge")
    assert not (moved & ~edge).any()


def test_ellipj_tensor_loop_follows_the_numpy_loop():
    """Quincuncial's tensor _ellipj (a Python loop of torch operations over the
    reversed AGM constants) against the NumPy loop: in float64 within 1e-13
    (the ulps of two libms), and on float32 inputs no farther from the NumPy
    loop than the JAX package's lax.scan is."""
    import torch

    from blinky_tpu.lenses.quincuncial import _ellipj as jellipj
    from blinky_tpu_torch.lenses.quincuncial import _ellipj

    u = np.random.default_rng(0).uniform(-8, 8, 200_000)
    for got, want in zip(_ellipj(torch.from_numpy(u)), _ellipj(u)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)
    u32 = u.astype(np.float32)
    for name, got, want, jax_out in zip(("sn", "cn", "dn", "ph"),
                                        _ellipj(torch.from_numpy(u32)), _ellipj(u32),
                                        jellipj(jnp.asarray(u32))):
        assert got.dtype == torch.float32 and want.dtype == np.float32
        gap = float(np.abs(got.numpy() - want).max())
        jgap = float(np.abs(np.asarray(jax_out) - want).max())
        print(f"{name}: tensor loop {gap:.3g}, lax.scan {jgap:.3g} from the NumPy loop")
        assert gap <= jgap, name
