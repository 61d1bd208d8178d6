"""The port's forward rasterizer (blinky_tpu_torch.lensmap.forward_raster)
against blinky_tpu's.

The rasterizer transcribes the reference's serial scatter, so its tables
are defined bit for bit: every comparison here has tolerance 0.  At 96x72
(the JAX package's tests/test_forward_raster.py size), for each of the ten
forward-only lenses:

* the invariants of tests/test_forward_raster.py hold for the port's build;
* the port's ``build_forward`` equals blinky_tpu's through the native quad
  fill and through the Python loop, with the identity view and a rotated
  ``view_basis``, and where tint comes from an earlier off-grid writer;
* ``build_ray_table`` and ``ray_table_from_lensmap`` of a forward lens equal
  blinky_tpu's.
"""

import numpy as np
import pytest

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.camera import view_basis_from_angles as jview_basis
from blinky_tpu.kernels import static_ray as jstatic_ray
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.lensmap.forward_raster import build_forward as jbuild_forward
from blinky_tpu_torch import globes, lenses, native
from blinky_tpu_torch.camera import view_basis_from_angles
from blinky_tpu_torch.kernels import static_ray
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.lensmap.builder import TINT_NONE, rubix_grid_mask
from blinky_tpu_torch.lensmap.forward_raster import build_forward

W, H = 96, 72
S = min(W, H)
FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
# every forward-only lens shipped (10 of 31; lenses/README.md "Mapping")
FORWARD_ONLY = ["eckert1", "eckert5", "sinusoidal", "winkel1", "winkel2",
                "kavrayskiy7", "wagner6", "larrivee", "gins8", "polyconic"]
ANGLES = (10.0, 30.0, 5.0)


def _zoom(name):
    # polyconic declares no lens bounds; its onload is f_fov 360
    return ("fov", 360) if name == "polyconic" else ("contain",)


def _pair(name, globe_name="cube"):
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    jl, lens = jlenses.get(name, jg), lenses.get(name, g)
    scale = calc_scale(Zoom(*_zoom(name)), lens, W, H)
    assert scale == jcalc(JZoom(*_zoom(name)), jl, W, H)
    return jg, jl, g, lens, scale


def _equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.scale == want.scale


@pytest.mark.parametrize("name", FORWARD_ONLY)
def test_forward_lens_builds(name):
    """tests/test_forward_raster.py::test_forward_lens_builds on the port."""
    _, _, g, lens, scale = _pair(name)
    assert lens.map_type == "forward"
    lm = build_lensmap(lens, g, scale, W, H)
    assert lm.valid.sum() > 0.25 * lm.valid.size, name
    assert lm.plates_used.sum() >= 4, name
    assert ((lm.px >= 0) & (lm.px < S) & (lm.py >= 0) & (lm.py < S)).all()
    # a tint byte is a plate index or TINT_NONE, and only written pixels carry one
    assert ((lm.tint == TINT_NONE) | (lm.tint < g.numplates)).all()
    assert (lm.tint[~lm.valid] == TINT_NONE).all()


@pytest.mark.parametrize("view", ["identity", "rotated"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", FORWARD_ONLY)
def test_build_forward_bit_equals_jax(name, use_native, view):
    jg, jl, g, lens, scale = _pair(name)
    vb = None if view == "identity" else view_basis_from_angles(*ANGLES)
    jvb = None if view == "identity" else jview_basis(*ANGLES)
    if vb is not None:
        for a, b in zip(vb, jvb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = build_forward(lens, g, scale, W, H, S, use_native=use_native, view_basis=vb)
    want = jbuild_forward(jl, jg, scale, W, H, S, use_native=use_native, view_basis=jvb)
    _equal(got, want)
    if use_native:
        assert native.available()  # the native fill ran, not the loop
        # the native fill and the Python loop give the same tables
        _equal(build_forward(lens, g, scale, W, H, S, use_native=False, view_basis=vb), got)


@pytest.mark.parametrize("name", ["eckert1", "polyconic", "gins8"])
def test_tint_comes_from_the_last_off_grid_writer(name):
    """Where an on-grid texel overwrote a pixel, the pixel keeps the tint of
    the earlier off-grid writer (set_lensmap_grid writes the tint byte only
    for off-grid texels): such pixels exist, and the port's tint equals
    blinky_tpu's there, on the default grid and on a coarse one."""
    jg, jl, g, lens, scale = _pair(name)
    for grid in ((10, 4.0, 1.0), (3, 2.0, 2.0)):
        got = build_forward(lens, g, scale, W, H, S, *grid)
        want = jbuild_forward(jl, jg, scale, W, H, S, *grid)
        _equal(got, want)
        on_grid = rubix_grid_mask(got.px.astype(np.float64), got.py.astype(np.float64),
                                  S, float(grid[0]), grid[1], grid[2])
        kept = got.valid & on_grid & (got.tint != TINT_NONE)
        assert kept.any(), grid
        # an earlier writer's plate, not always the final one
        if grid == (10, 4.0, 1.0):
            assert (kept & (got.tint != got.plate)).any()


@pytest.mark.parametrize("name", FORWARD_ONLY)
def test_native_fill_is_deterministic(name):
    """tests/test_forward_raster.py::test_forward_is_deterministic_and_native_matches:
    two builds agree."""
    _, _, g, lens, scale = _pair(name)
    a = build_forward(lens, g, scale, W, H, S)
    b = build_forward(lens, g, scale, W, H, S)
    _equal(a, b)


def test_forward_agrees_with_inverse_path():
    """tests/test_forward_raster.py::test_forward_agrees_with_inverse_path on
    the port: equirect forced to its forward map against its inverse build;
    interior pixels agree (seams rasterize to the +-1 px neighbour)."""
    from blinky_tpu_torch.lenses import equirect, resolve

    g = globes.get("cube")
    lens_inv = lenses.get("equirect", g)
    spec = equirect.make(None)
    spec["map"] = "lens_forward"
    lens_fwd = resolve("equirect", spec)
    assert lens_fwd.map_type == "forward"
    scale = calc_scale(Zoom("contain"), lens_inv, W, H)
    lm_i = build_lensmap(lens_inv, g, scale, W, H)
    lm_f = build_lensmap(lens_fwd, g, scale, W, H)
    both = lm_i.valid & lm_f.valid
    assert both.sum() > 0.8 * lm_i.valid.sum()
    agree = (lm_i.plate[both] == lm_f.plate[both]).mean()
    assert agree > 0.95, agree
    same = both & (lm_i.plate == lm_f.plate)
    density = int(np.ceil(lm_i.platesize * scale / (np.pi / 2))) + 1
    dpx = np.abs(lm_i.px[same] - lm_f.px[same])
    dpy = np.abs(lm_i.py[same] - lm_f.py[same])
    assert np.percentile(dpx, 99) <= 2 * density and np.percentile(dpy, 99) <= 2 * density
    # and the forced forward build equals blinky_tpu's
    from blinky_tpu.lenses import equirect as jequirect
    from blinky_tpu.lenses import resolve as jresolve

    jspec = jequirect.make(None)
    jspec["map"] = "lens_forward"
    jg = jglobes.get("cube")
    _equal(lm_f, jbuild_forward(jresolve("equirect", jspec), jg, scale, W, H, S))


def _tables_equal(got, want):
    assert (got.width_px, got.height_px, got.source) == (
        want.width_px, want.height_px, want.source) == (want.width_px, want.height_px, "lensmap")
    for f in ("vx", "vy", "vz", "lens_valid"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("globe_name", ["cube", "fast"])
@pytest.mark.parametrize("name", ["eckert1", "polyconic", "wagner6"])
def test_ray_tables_of_a_forward_lens_bit_equal_jax(name, globe_name):
    """build_ray_table rasterizes a forward lens when no lensmap of its size
    and scale is given, reuses one that is, and ray_table_from_lensmap turns
    either into texel-centre rays: all equal to blinky_tpu's."""
    jg, jl, g, lens, scale = _pair(name, globe_name)
    want = jstatic_ray.build_ray_table(jl, jg, scale, W, H, S)
    _tables_equal(static_ray.build_ray_table(lens, g, scale, W, H, S, device="cpu"), want)
    lm = build_lensmap(lens, g, scale, W, H, S)
    _tables_equal(static_ray.build_ray_table(lens, g, scale, W, H, S, lensmap=lm,
                                             device="cpu"), want)
    _tables_equal(static_ray.ray_table_from_lensmap(lm, g),
                  jstatic_ray.ray_table_from_lensmap(jbuild_forward(jl, jg, scale, W, H, S), jg))
    # at render scale 2: the build grid with the zoom scale times 2; a
    # lensmap of another size is not reused
    half = jstatic_ray.build_ray_table(jl, jg, scale * 2, W // 2, H // 2, S)
    _tables_equal(static_ray.build_ray_table(lens, g, scale * 2, W // 2, H // 2, S,
                                             lensmap=lm, device="cpu"), half)


def test_native_fill_checks_its_buffers():
    """The native fill writes through raw pointers: arrays of the wrong
    shape, dtype or layout raise before any pointer is passed."""
    assert native.available()
    n = 4
    corners = np.zeros((n + 1, n + 1), np.int64)
    ok = np.ones((n + 1, n + 1), bool)
    texels = np.ones((n, n), bool)

    def tables(h=6, w=8):
        return (np.full((h, w), -1, np.int32), np.zeros((h, w), np.int32),
                np.zeros((h, w), np.int32), np.full((h, w), TINT_NONE, np.uint8))

    assert native.forward_rasterize_plate(corners, corners, ok, texels, texels, 0,
                                          *tables()) is True
    with pytest.raises(ValueError, match="where"):
        native.forward_rasterize_plate(corners[:-1], corners, ok, texels, texels, 0, *tables())
    plate, px, py, tint = tables()
    for bad in ((plate, px.astype(np.int64), py, tint), (plate, px, py[:, :-1], tint),
                (plate, px, np.asfortranarray(py), tint), (plate, px, py, tint.astype(np.int32))):
        with pytest.raises(ValueError, match="C-contiguous"):
            native.forward_rasterize_plate(corners, corners, ok, texels, texels, 0, *bad)
