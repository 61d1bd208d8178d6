"""Randomized parity of the port's lensmap chain (blinky_tpu_torch) against
blinky_tpu's, on random and odd globes.

The fixed-config suites (tests/test_torch_lensmap.py, test_torch_lenses.py)
cover the shipped globes, whose frames are axis-aligned or symmetric.  As
tests/test_fuzz_parity.py does for the JAX package, this file fuzzes the
globe space: 1-6 plates with seeded forwards off the axes, ups that are not
parallel to them and fovs of 25-170 degrees
(``bench/fuzz_globes.py::random_plates``, the JAX test's draw), and three
odd layouts (one plate; two with one forward beside a third, a tie the
first plate must win; two opposite plates), each through both packages'
``make_globe``.  At 48x36, over the JAX test's five lens/zoom pairs plus
mercator and eckert1 (a forward lens: ``forward_raster.py``):

* the exact build (``backend="numpy"``) under random rubix geometry
  bit-equals ``blinky_tpu``'s and, for an inverse lens, the port's
  per-pixel oracle (``parity/oracle.py``) on ``valid``, ``flat_idx``,
  ``plate``, ``tint`` and ``plates_used`` (tolerance 0);
* the float32 build (``backend="torch"`` on the CPU) of an inverse lens
  differs from the JAX float32 builder's on at most ``F32_SHARE`` of the
  pixels (the reference's boundary tolerance, tests/test_lensmap_parity.py),
  and where both are valid on one plate ``px`` and ``py`` lie within one
  texel; a forward lens's equals the exact build;
* exact builds under random view bases bit-equal ``blinky_tpu``'s and the
  oracle run on the rotated lens, the JAX test's composition;
* random frames and background through ``RemapKernel`` with ``rubix`` on a
  random 5-plate globe bit-equal ``blinky_tpu``'s ``RemapKernel`` and
  ``oracle_remap``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.parity.oracle import oracle_inverse_lensmap as joracle
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.bench.fuzz_globes import ODD_PLATES, random_plates, random_rubix_grid
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.parity.oracle import oracle_inverse_lensmap, oracle_remap

W, H = 48, 36
S = min(W, H)
F32_SHARE = 0.15  # tests/test_lensmap_parity.py's bound for float32 noise
TABLES = ("valid", "flat_idx", "plate", "tint", "plates_used")
FIELDS = TABLES + ("px", "py")

LENS_ZOOMS = [
    ("panini", ("fov", 140)),
    ("stereographic", ("fov", 220)),
    ("fisheye1", ("contain",)),
    ("equirect", ("contain",)),
    ("hammer", ("vfov", 120)),
    ("mercator", ("cover",)),
    ("eckert1", ("contain",)),
]
SEEDS = range(28)  # four random globes a lens


def _case(case):
    """(name, plates, lens name, zoom, rubix grid) of a case id: ``seed<n>``
    (a random globe on lens ``n % 7``) or ``<odd layout>-<lens name>``."""
    if case.startswith("seed"):
        seed = int(case[4:])
        rng = np.random.default_rng(100 + seed)
        plates = random_plates(rng, int(rng.integers(1, 7)))
        lens_name, zoom = LENS_ZOOMS[seed % len(LENS_ZOOMS)]
        return f"fuzz{len(plates)}", plates, lens_name, zoom, random_rubix_grid(rng)
    odd, lens_name = case.split("-")
    zoom = dict(LENS_ZOOMS)[lens_name]
    return odd, ODD_PLATES[odd], lens_name, zoom, (7, 2.5, 1.5)


CASES = [f"seed{s}" for s in SEEDS] + [f"{odd}-{lens}" for odd in ODD_PLATES
                                       for lens, _ in LENS_ZOOMS]
INVERSE_CASES = [c for c in CASES if _case(c)[2] != "eckert1"]


def _both(case):
    name, plates, lens_name, zoom, grid = _case(case)
    g, jg = globes.make_globe(name, plates), jglobes.make_globe(name, plates)
    lens, jl = lenses.get(lens_name, g), jlenses.get(lens_name, jg)
    scale = calc_scale(Zoom(*zoom), lens, W, H)
    assert scale == jcalc(JZoom(*zoom), jl, W, H)
    return g, jg, lens, jl, scale, grid


@pytest.mark.parametrize("case", CASES)
def test_exact_build_bit_equals_jax_and_oracle(case):
    g, jg, lens, jl, scale, grid = _both(case)
    for f in ("forward", "right", "up", "fov_rad", "dist"):
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=f)
    lm = build_lensmap(lens, g, scale, W, H, S, *grid, backend="numpy")
    jlm = jbuild(jl, jg, scale, W, H, S, *grid, backend="numpy").to_numpy()
    for f in FIELDS:
        a, b = getattr(lm, f), getattr(jlm, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if lens.map_type == "forward":  # the oracle is the inverse builder's
        return
    o = oracle_inverse_lensmap(lens, g, scale, W, H, S, *grid)
    np.testing.assert_array_equal(lm.valid, o["valid"])
    np.testing.assert_array_equal(lm.flat_idx, o["flat_idx"])
    np.testing.assert_array_equal(lm.plate, np.where(o["valid"], o["plate"], -1))
    np.testing.assert_array_equal(lm.tint, o["tint"])
    np.testing.assert_array_equal(lm.plates_used, o["plates_used"])


def test_odd_globes_select_as_laid_out():
    """The tie layout never selects its second plate (its forward equals the
    first's, and the first wins every tie); the one-plate globe uses plate 0
    only; stereographic f_fov 220 sees past 90 degrees, onto the plate
    opposite the first."""
    used = {}
    for odd, lens_name in (("one", "panini"), ("tie", "panini"),
                           ("opposite", "stereographic")):
        g, _, lens, _, scale, grid = _both(f"{odd}-{lens_name}")
        lm = build_lensmap(lens, g, scale, W, H, S, *grid, backend="numpy")
        used[odd] = lm.plates_used[:g.numplates].tolist()
    assert used == {"one": [True], "tie": [True, False, True], "opposite": [True, True]}


@pytest.mark.parametrize("case", INVERSE_CASES)
def test_f32_build_within_tolerance_of_jax_f32(case):
    g, jg, lens, jl, scale, grid = _both(case)
    lm = build_lensmap(lens, g, scale, W, H, S, *grid, backend="torch", device="cpu")
    assert isinstance(lm.flat_idx, torch.Tensor)
    got = lm.to_numpy()
    jlm = jbuild(jl, jg, scale, W, H, S, *grid, backend="jax",
                 dtype=jnp.float32).to_numpy()
    exact = build_lensmap(lens, g, scale, W, H, S, *grid, backend="numpy")
    for want in (jlm, exact):
        for f in FIELDS:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
        share = float((got.flat_idx != np.asarray(want.flat_idx)).mean())
        assert share <= F32_SHARE, share
        same = got.valid & np.asarray(want.valid) & (got.plate == np.asarray(want.plate))
        for f in ("px", "py"):
            d = np.abs(getattr(got, f) - np.asarray(getattr(want, f)))[same]
            assert d.max(initial=0) <= 1, f


@pytest.mark.parametrize("case", [c for c in CASES if _case(c)[2] == "eckert1"])
def test_f32_build_of_forward_lens_is_the_exact_build(case):
    """A forward lens has no float32 builder: ``backend="torch"`` rasterizes
    on the host and returns the exact tables."""
    g, _, lens, _, scale, grid = _both(case)
    lm = build_lensmap(lens, g, scale, W, H, S, *grid, backend="torch", device="cpu")
    exact = build_lensmap(lens, g, scale, W, H, S, *grid, backend="numpy")
    for f in FIELDS:
        assert isinstance(getattr(lm, f), np.ndarray), f
        np.testing.assert_array_equal(getattr(lm, f), getattr(exact, f), err_msg=f)


@pytest.mark.parametrize("seed", range(4))
def test_random_view_bases_bit_equal_jax_and_oracle_composition(seed):
    """A random globe under a random view basis: the rotated exact build
    bit-equals the JAX package's, and an oracle run on the lens whose
    inverse applies the same rotation (tests/test_fuzz_parity.py's
    composition) on ``valid`` and ``flat_idx``."""
    from blinky_tpu.camera import view_basis_from_angles as jbasis
    from blinky_tpu_torch.camera import view_basis_from_angles

    rng = np.random.default_rng(7 + seed)
    plates = random_plates(rng, int(rng.integers(1, 7)))
    g, jg = globes.make_globe("fuzzv", plates), jglobes.make_globe("fuzzv", plates)
    lens, jl = lenses.get("panini", g), jlenses.get("panini", jg)
    scale = calc_scale(Zoom("fov", 160), lens, W, H)
    angles = rng.uniform(-80, 80), rng.uniform(0, 360), rng.uniform(-45, 45)
    basis = view_basis_from_angles(*angles)
    for a, b in zip(basis, jbasis(*angles), strict=True):
        np.testing.assert_array_equal(a, b)
    lm = build_lensmap(lens, g, scale, W, H, S, backend="numpy", view_basis=basis)
    jlm = jbuild(jl, jg, scale, W, H, S, backend="numpy",
                 view_basis=jbasis(*angles)).to_numpy()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(lm, f), getattr(jlm, f), err_msg=f)
    fwd_v, rgt_v, up_v = (np.asarray(v, np.float64) for v in basis)

    class RotLens:
        map_type = lens.map_type
        forward = lens.forward

        @staticmethod
        def inverse(x, y_):
            vx, vy, vz, ok = lens.inverse(x, y_)
            return (vx * rgt_v[0] + vy * up_v[0] + vz * fwd_v[0],
                    vx * rgt_v[1] + vy * up_v[1] + vz * fwd_v[1],
                    vx * rgt_v[2] + vy * up_v[2] + vz * fwd_v[2],
                    ok)

    o = oracle_inverse_lensmap(RotLens, g, scale, W, H, S)
    np.testing.assert_array_equal(lm.valid, o["valid"])
    np.testing.assert_array_equal(lm.flat_idx, o["flat_idx"])
    jo = joracle(RotLens, jg, scale, W, H, S)
    for f in TABLES:
        np.testing.assert_array_equal(o[f], jo[f], err_msg=f)


@pytest.mark.parametrize("seed", [11, 12])
def test_random_frames_rubix_remap_bit_equals_jax_and_oracle(seed):
    from blinky_tpu.kernels.remap import RemapKernel as JRemapKernel
    from blinky_tpu_torch.kernels.remap import RemapKernel
    from blinky_tpu_torch.palette import create_palmap, default_palette

    rng = np.random.default_rng(seed)
    plates = random_plates(rng, 5)
    g, jg = globes.make_globe("fuzz5", plates), jglobes.make_globe("fuzz5", plates)
    lens, jl = lenses.get("stereographic", g), jlenses.get("stereographic", jg)
    scale = calc_scale(Zoom("fov", 200), lens, W, H)
    lm = build_lensmap(lens, g, scale, W, H, S, backend="numpy")
    jlm = jbuild(jl, jg, scale, W, H, S, backend="numpy")
    pal = default_palette()
    frames = rng.integers(0, 256, (6, S, S), np.uint8)
    bg = rng.integers(0, 256, (H, W), np.uint8)
    got = RemapKernel(lm, pal, bg, device="cpu")(frames, rubix=True)
    assert got.device.type == "cpu" and got.dtype == torch.uint8
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(JRemapKernel(jlm, pal, background=bg)(
        frames, rubix=True)))
    exp = oracle_remap(dict(valid=lm.valid, plate=lm.plate, px=lm.px, py=lm.py, tint=lm.tint),
                       frames, bg, rubix_enabled=True, palmap=create_palmap(pal))
    np.testing.assert_array_equal(got, exp)
    assert lm.valid.any() and not lm.valid.all()
