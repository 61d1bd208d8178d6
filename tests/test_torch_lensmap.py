"""The port's lensmap chain (blinky_tpu_torch) against blinky_tpu's.

The exact float64 host builder, the zoom solver, the globes and the panini
lens of the port must reproduce the JAX package's bit for bit (tolerance 0:
the tables are integers and the scales exact float64).  The float32 builder
on tensors (``backend="torch"``: the lens stage, then the resolve's plain
version on the CPU) is held to ``build_lensmap(backend="jax",
dtype=float32)`` by the reference's own tolerance for float32 noise
(tests/test_lensmap_parity.py:78-102): ``flat_idx`` differs on at most
``F32_SHARE`` = 0.15 of the pixels at 64x48, where texel boundaries
dominate, and where both are valid on the same plate ``px`` and ``py`` lie
within one texel.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import ZoomError as JZoomError
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.lensmap import Zoom, ZoomError, build_lensmap, calc_scale

W, H, S = 64, 48, 48
FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
GOLDEN = Path(__file__).parent / "goldens" / "panini__cube__fov180.npz"


def _both(globe_name, zoom=("fov", 180), grid=(10, 4.0, 1.0), size=(W, H, S)):
    w, h, s = size
    jg = jglobes.get(globe_name)
    jl = jlenses.get("panini", jg)
    jlm = jbuild(jl, jg, jcalc(JZoom(*zoom), jl, w, h), w, h, s, *grid,
                 backend="numpy").to_numpy()
    g = globes.get(globe_name)
    lens = lenses.get("panini", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom(*zoom), lens, w, h), w, h, s,
                       *grid)
    return jlm, lm


@pytest.mark.parametrize("globe_name", jglobes.names())
def test_panini_lensmap_bit_equals_jax_on_every_globe(globe_name):
    assert globes.names() == jglobes.names()
    jlm, lm = _both(globe_name)
    assert lm.scale == jlm.scale
    assert (lm.width_px, lm.height_px, lm.platesize, lm.numplates) == (
        jlm.width_px, jlm.height_px, jlm.platesize, jlm.numplates)
    for f in FIELDS:
        a, b = getattr(lm, f), getattr(jlm, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("zoom,grid,size", [
    (("fov", 120), (5, 3.0, 2.0), (64, 48, 48)),
    (("vfov", 90), (10, 4.0, 1.0), (61, 37, 40)),
])
def test_panini_lensmap_other_zooms_grids_and_sizes(zoom, grid, size):
    jlm, lm = _both("cube", zoom, grid, size)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(lm, f), getattr(jlm, f), err_msg=f)


def test_panini_lensmap_matches_golden():
    _, lm = _both("cube")
    with np.load(GOLDEN) as z:
        assert lm.scale == float(z["scale"])
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(lm, f), z[f], err_msg=f)


@pytest.mark.parametrize("zoom", [("fov", 180), ("fov", 97), ("vfov", 120),
                                  ("vfov", 33), ("cover",), ("contain",),
                                  ("fov", 400), ("vfov", 190)])
@pytest.mark.parametrize("size", [(64, 48), (1920, 1080), (37, 61)])
def test_calc_scale_exact(zoom, size):
    """The four zoom kinds give the JAX package's scale exactly, and the
    same error where it fails (panini declares no lens_width/height, so
    cover/contain fail; fov over max_fov fails)."""
    jg, g = jglobes.get("cube"), globes.get("cube")
    jl, lens = jlenses.get("panini", jg), lenses.get("panini", g)
    try:
        expect = jcalc(JZoom(*zoom), jl, *size)
    except JZoomError as e:
        with pytest.raises(ZoomError) as got:
            calc_scale(Zoom(*zoom), lens, *size)
        assert str(got.value) == str(e)
        return
    assert calc_scale(Zoom(*zoom), lens, *size) == expect


@pytest.mark.parametrize("name", jglobes.names())
def test_globes_equal(name):
    jg, g = jglobes.get(name), globes.get(name)
    assert g.numplates == jg.numplates
    for f in ("forward", "right", "up", "fov_rad", "dist"):
        np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def test_lens_registry():
    assert "panini" in lenses.BUILTIN_LENSES and len(lenses.BUILTIN_LENSES) == 31
    assert lenses.BUILTIN_LENSES == jlenses.BUILTIN_LENSES
    for name in ("panini", "quincuncial", "eckert1", "debug"):
        lens, jl = lenses.get(name, globes.get("cube")), jlenses.get(
            name, jglobes.get("cube"))
        for f in ("map_type", "width", "height", "max_fov", "max_vfov", "onload"):
            assert getattr(lens, f) == getattr(jl, f), (name, f)
    # a lens whose metadata needs no globe loads without one; debug's layout
    # needs numplates, and both packages refuse it alike
    assert lenses.get("quincuncial").map_type == "inverse"
    assert lenses.get("eckert1").map_type == "forward"
    with pytest.raises(ValueError, match="globe context"):
        jlenses.get("debug")
    with pytest.raises(ValueError, match="globe context"):
        lenses.get("debug")
    with pytest.raises(KeyError):
        lenses.get("nosuch")


def test_builder_backends_and_to_torch():
    _, lm = _both("cube")
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    f32 = build_lensmap(lens, g, lm.scale, W, H, S, backend="torch", device="cpu")
    assert isinstance(f32.flat_idx, torch.Tensor) and f32.to_torch("cpu")["px"] is f32.px
    assert isinstance(f32.to_numpy().flat_idx, np.ndarray)
    with pytest.raises(ValueError):
        build_lensmap(lens, g, lm.scale, W, H, S, backend="jax")
    t = lm.to_torch("cpu")
    assert set(t) == set(FIELDS)
    for f in FIELDS:
        assert t[f].device == torch.device("cpu")
        np.testing.assert_array_equal(t[f].numpy(), getattr(lm, f), err_msg=f)


# ------------------------------------------------------ the float32 builder

F32_SHARE = 0.15
VIEW = (10.0, 30.0, 5.0)


def _f32_both(globe_name, view, grid=(10, 4.0, 1.0), size=(W, H, S), zoom=("fov", 180)):
    from blinky_tpu.camera import view_basis_from_angles as jbasis
    from blinky_tpu_torch.camera import view_basis_from_angles

    w, h, s = size
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    jl, lens = jlenses.get("panini", jg), lenses.get("panini", g)
    scale = calc_scale(Zoom(*zoom), lens, w, h)
    jlm = jbuild(jl, jg, scale, w, h, s, *grid, backend="jax", dtype=jnp.float32,
                 view_basis=jbasis(*VIEW) if view else None).to_numpy()
    vb = view_basis_from_angles(*VIEW) if view else None
    lm = build_lensmap(lens, g, scale, w, h, s, *grid, backend="torch", device="cpu",
                       view_basis=vb)
    exact = build_lensmap(lens, g, scale, w, h, s, *grid, view_basis=vb)
    return jlm, lm, exact


@pytest.mark.parametrize("view", [False, True], ids=["identity", "rotated"])
@pytest.mark.parametrize("globe_name", ["cube", "fast", "tetra"])
def test_f32_build_within_tolerance_of_jax_f32_and_exact(globe_name, view):
    jlm, lm, exact = _f32_both(globe_name, view)
    assert isinstance(lm.flat_idx, torch.Tensor) and lm.scale == jlm.scale
    got = lm.to_numpy()
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(jlm, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
    for want, what in ((jlm, "the JAX float32 build"), (exact, "the exact build")):
        share = float((got.flat_idx != np.asarray(want.flat_idx)).mean())
        print(f"{globe_name} {'rotated' if view else 'identity'}: {share:.4f} of the pixels "
              f"differ from {what}")
        assert share <= F32_SHARE
        same = got.valid & np.asarray(want.valid) & (got.plate == np.asarray(want.plate))
        for f in ("px", "py"):
            d = np.abs(getattr(got, f) - np.asarray(getattr(want, f)))[same]
            assert d.max(initial=0) <= 1, (what, f)
    np.testing.assert_array_equal(got.plates_used, np.asarray(jlm.plates_used))
    np.testing.assert_array_equal(np.asarray(lm.tint_c), got.tint_c)


@pytest.mark.parametrize("grid,size,zoom", [
    ((5, 3.0, 2.0), (64, 48, 48), ("fov", 120)),
    ((0, 0.0, 0.0), (61, 37, 40), ("vfov", 90)),
])
def test_f32_build_other_zooms_grids_and_sizes(grid, size, zoom):
    jlm, lm, _ = _f32_both("cube", True, grid, size, zoom)
    got = lm.to_numpy()
    assert float((got.flat_idx != jlm.flat_idx).mean()) <= F32_SHARE
    # where both chose the same texel the tint (the rubix grid test) agrees
    same = got.valid & jlm.valid & (got.flat_idx == jlm.flat_idx)
    np.testing.assert_array_equal(got.tint[same], jlm.tint[same])


def test_lens_ray_grid_signature_and_zoom_steps():
    """lens_ray_grid takes the JAX signature's namespace, dtype and row
    range: a row block equals the same rows of the whole grid, a 1-d scale
    gives a grid a zoom step, each equal to its own build."""
    from blinky_tpu.lensmap.builder import lens_ray_grid as jgrid
    from blinky_tpu_torch.lensmap.builder import lens_ray_grid, lens_rays_torch

    jg, g = jglobes.get("cube"), globes.get("cube")
    jl, lens = jlenses.get("panini", jg), lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    want = jgrid(jl, np.float64(scale), W, H, np, np.float64, row_range=(5, 9))
    got = lens_ray_grid(lens, np.float64(scale), W, H, np, np.float64, row_range=(5, 9))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.broadcast_to(a, (4, W)), np.broadcast_to(b, (4, W)))
    whole = lens_rays_torch(lens, scale, W, H, "cpu")
    block = lens_ray_grid(lens, scale, W, H, torch, torch.float32, "cpu", row_range=(5, 9))
    for a, b in zip(block[:3], whole[:3]):
        assert a.dtype == torch.float32
        assert torch.equal(torch.broadcast_to(a, (4, W)), b[5:9])
    steps = lens_rays_torch(lens, np.array([scale, 2 * scale, scale / 3]), W, H, "cpu")
    assert tuple(steps[0].shape) == (3, H, W) and steps[3].dtype == torch.bool
    for n, s_ in enumerate((scale, 2 * scale, scale / 3)):
        one = lens_rays_torch(lens, s_, W, H, "cpu")
        for a, b in zip(steps, one):
            assert torch.equal(a[n], b)


def test_lensmap_resolve_is_the_plain_version_on_the_cpu():
    """K8's wrapper on CPU tensors runs rays_to_lensmap_torch with the basis
    it is given, always rotating; it checks its operands and counts no
    launch."""
    from blinky_tpu_torch.lensmap import builder

    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    rays = builder.lens_rays_torch(lens, scale, W, H, "cpu")
    n0 = builder.lensmap_resolve.launches
    got = builder.lensmap_resolve(g, *rays, S, 10, 4.0, 1.0, builder.IDENTITY_BASIS)
    assert builder.lensmap_resolve.launches == n0
    want = builder.rays_to_lensmap_torch(
        g, *rays, S, 10, 4.0, 1.0,
        view_basis=torch.tensor(builder.IDENTITY_BASIS, dtype=torch.float32))
    for f in FIELDS:
        assert torch.equal(got[f], want[f]), f
    with pytest.raises(ValueError, match="contiguous"):
        builder.lensmap_resolve(g, rays[0].double(), *rays[1:], S, 10, 4.0, 1.0,
                                builder.IDENTITY_BASIS)
    with pytest.raises(ValueError, match="contiguous"):
        builder.lensmap_resolve(g, rays[0].t(), *rays[1:], S, 10, 4.0, 1.0,
                                builder.IDENTITY_BASIS)
    with pytest.raises(ValueError, match="view_basis"):
        builder.lensmap_resolve(g, *rays, S, 10, 4.0, 1.0, np.eye(4))
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        build_lensmap(lens, g, scale, W, H, S, backend="torch")  # the card, and none here


def test_rays_with_inf_and_nan_rotated_or_not():
    """Rotation by the identity is not no rotation: for a ray with an
    infinite component the identity basis makes the other components NaN
    (inf * 0) where no rotation leaves them.  The JAX float32 builder always
    rotates (an explicit identity when there is no view) and its zoom sweep
    never does; the port's resolve follows each, equal to the JAX package's
    NumPy float32 path with and without a basis.  Both call such a pixel
    invalid: the normalize turns the infinite component itself into NaN."""
    from blinky_tpu.lensmap.builder import rays_to_lensmap as jrays
    from blinky_tpu_torch.lensmap.builder import IDENTITY_BASIS, rays_to_lensmap_torch

    odd = [(np.inf, 0.0, 1.0), (0.0, np.inf, 1.0), (0.2, 0.1, np.inf), (-np.inf, 0.0, 1.0),
           (np.nan, 0.3, 1.0), (0.0, 0.0, 0.0), (1e-30, 0.0, 0.0), (3e-39, -1e-21, 2e-45),
           (0.1, 0.2, 1.0), (0.0, 0.0, 1.0), (1e19, -1e19, 1e19), (0.0, 0.0, -1.0)]
    vx, vy, vz = (np.ascontiguousarray(a.reshape(3, 4))
                  for a in np.array(odd, np.float32).T)
    lv = np.ones((3, 4), bool)
    ident = tuple(np.asarray(v) for v in IDENTITY_BASIS)
    for globe_name in ("cube", "fast"):
        jg, g = jglobes.get(globe_name), globes.get(globe_name)
        tables = {}
        for basis in (None, ident):
            with np.errstate(all="ignore"):
                want = jrays(jg, vx, vy, vz, lv, 16, 10.0, 4.0, 1.0, np, np.float32,
                             view_basis=basis)
            got = rays_to_lensmap_torch(
                g, *(torch.from_numpy(a) for a in (vx, vy, vz, lv)), 16, 10.0, 4.0, 1.0,
                view_basis=None if basis is None else torch.tensor(IDENTITY_BASIS))
            for f in FIELDS:
                np.testing.assert_array_equal(got[f].numpy(), want[f], err_msg=f)
            tables[basis is None] = got
        assert not tables[True]["valid"].reshape(-1)[:5].any()
        assert tables[True]["valid"].any()
        for f in FIELDS:  # the rotation changes no table
            assert torch.equal(tables[True][f], tables[False][f]), f


def test_device_builder_warm():
    from blinky_tpu_torch.lensmap import device_builder_warm

    g = globes.get("cube_edge")
    lens = lenses.get("panini", g)
    assert not device_builder_warm(lens, g, 40, 30, device="cpu")
    build_lensmap(lens, g, 0.05, 40, 30, backend="torch", device="cpu")
    assert device_builder_warm(lens, g, 40, 30, device="cpu")
    assert device_builder_warm(lens, g, 40, 30, 30, device="cpu")
    assert not device_builder_warm(lens, g, 40, 30)  # not on the card
    assert not device_builder_warm(lens, g, 42, 30, device="cpu")


# ------------------------------------------------------ the parity oracle
@pytest.mark.parametrize("globe_name", ["cube", "fast"])
@pytest.mark.parametrize("name", ["quincuncial", "debug"])
def test_oracle_inverse_lensmap_equals_jax_and_the_builder(name, globe_name):
    """The port's scalar oracle (blinky_tpu_torch.parity) at 32x24: every
    table equal to blinky_tpu's oracle and to the port's NumPy builder
    (tolerance 0: both are the per-pixel float64 transcription)."""
    from blinky_tpu.parity import oracle_inverse_lensmap as joracle
    from blinky_tpu_torch.parity import oracle_inverse_lensmap

    w, h = 32, 24
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    jl, lens = jlenses.get(name, jg), lenses.get(name, g)
    scale = calc_scale(Zoom("contain"), lens, w, h)
    assert scale == jcalc(JZoom("contain"), jl, w, h)
    got = oracle_inverse_lensmap(lens, g, scale, w, h, h)
    want = joracle(jl, jg, scale, w, h, h)
    built = build_lensmap(lens, g, scale, w, h, h)
    assert got["valid"].any()
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_array_equal(got[f], getattr(built, f), err_msg=f)


def test_oracle_remap_equals_jax_and_the_remap_kernel():
    """oracle_remap of a rubix screen: equal to blinky_tpu's and to the
    port's RemapKernel on the CPU."""
    from blinky_tpu.palette import create_palmap as jcreate_palmap
    from blinky_tpu.parity import oracle_remap as joracle_remap
    from blinky_tpu_torch.kernels.remap import RemapKernel, expand_frames_tinted
    from blinky_tpu_torch.palette import create_palmap, default_palette
    from blinky_tpu_torch.parity import oracle_remap

    w, h = 32, 24
    g = globes.get("cube")
    lens = lenses.get("quincuncial", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom("contain"), lens, w, h), w, h, h)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (6, h, h), np.uint8)
    bg = rng.integers(0, 256, (h, w), np.uint8)
    pal = default_palette()
    table = dict(valid=lm.valid, plate=lm.plate, px=lm.px, py=lm.py, tint=lm.tint)
    got = oracle_remap(table, frames, bg, rubix_enabled=True, palmap=create_palmap(pal))
    np.testing.assert_array_equal(
        got, joracle_remap(table, frames, bg, rubix_enabled=True, palmap=jcreate_palmap(pal)))
    kernel = RemapKernel(lm, pal, bg, device="cpu")
    np.testing.assert_array_equal(
        got, kernel(expand_frames_tinted(frames, pal), rubix=True).numpy())
