"""K6's cube resolver (``csrc/resolve.cuh``, kCube) on the CPU: which globes
take it, and a float32 NumPy twin of its plate pick held to the max-dot
select of :func:`rays_to_lensmap_torch`, which K6 must equal bit for bit.

The twin does what the kernel does after ``rotate_normalize``: the largest
forward dot is the largest magnitude ``m`` of the unit ray's components; of
the axes whose magnitude is ``m``, each names the plate facing the way its
component's sign points, and the first of those plates wins; ``rz`` is
``m``, and ``rx`` and ``ry`` are the chosen plate's signed components.  It
must give the plate, validity, ``px`` and ``py`` of the max-dot resolve on
seeded rays, on NaN, inf, zero, denormal and huge rays, and on rays that tie
between faces.  The card tests (``tests/test_torch_cuda.py``) hold the
kernel itself to the plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from blinky_tpu_torch import globes
from blinky_tpu_torch.bench import fuzz_globes
from blinky_tpu_torch.kernels import posed, static_ray
from blinky_tpu_torch.lensmap.builder import (
    cube_resolver, plate_dists_f32, rays_to_lensmap_torch, rotate_normalize_torch,
)

S = 48
GRID = (10.0, 4.0, 1.0)


def _cube_like(name, order=None, turn=None, drop=None, duplicate=False):
    """The cube's plates relabelled (*order*), turned by a right angle
    about y (*turn*), with a plate dropped, or with plate 3 facing plate
    0's way."""
    from blinky_tpu_torch.globes.builtin import _CUBE_PLATES

    plates = [tuple(p) for p in _CUBE_PLATES]
    if order is not None:
        plates = [plates[i] for i in order]
    if turn:
        def yaw(v):
            x, y, z = v
            return (z, y, -x)
        plates = [(yaw(f), yaw(u), fov) for f, u, fov in plates]
    if drop is not None:
        del plates[drop]
    if duplicate:
        plates[3] = plates[0]
    return globes.make_globe(name, plates)


def _script_cube():
    return dataclasses.replace(globes.get("cube"), plate_resolver=lambda x, y, z, g: 0 * x)


def _random_globe(seed, n):
    return globes.make_globe(f"random{seed}",
                             fuzz_globes.random_plates(np.random.default_rng(seed), n))


CHOICES = [
    ("cube", lambda: globes.get("cube"), True),
    ("relabelled", lambda: _cube_like("relabelled", order=[5, 3, 0, 4, 1, 2]), True),
    ("turned", lambda: _cube_like("turned", turn=True), True),
    ("cube_edge", lambda: globes.get("cube_edge"), False),
    ("cube_corner", lambda: globes.get("cube_corner"), False),
    ("trism", lambda: globes.get("trism"), False),
    ("tetra", lambda: globes.get("tetra"), False),
    ("fast", lambda: globes.get("fast"), False),
    ("script", _script_cube, False),
    ("random1", lambda: _random_globe(1, 6), False),
    ("random6", lambda: _random_globe(6, 4), False),
    ("five_axis_plates", lambda: _cube_like("five", drop=3), False),
    ("two_plates_one_way", lambda: _cube_like("twice", duplicate=True), False),
]


@pytest.mark.parametrize("make,want", [c[1:] for c in CHOICES], ids=[c[0] for c in CHOICES])
def test_cube_resolver_picks_cubes_only(make, want):
    """kCube for a max-dot globe whose six plates face the six signed axes
    with signed-axis frames; max-dot (or the globe's own resolver) for the
    rest, an axis-aligned globe that misses a direction included."""
    assert cube_resolver(make()) is want


def test_cube_resolver_is_made_once_a_globe():
    g = globes.get("cube")
    cube_resolver.cache_clear()
    assert cube_resolver(g) and cube_resolver(g)
    assert cube_resolver.cache_info().hits == 1


def test_cube_resolver_on_the_cpu_runs_the_plain_version():
    """On the CPU K6's wrapper runs its plain version: no launch is
    counted, of either kind."""
    g = globes.get("cube")
    rng = np.random.default_rng(3)
    hb, wb, B = 6, 8, 2
    t = static_ray.RayTable(wb, hb, *(rng.normal(size=(hb, wb)).astype(np.float32)
                                      for _ in range(3)), np.ones((hb, wb), bool))
    t = t.device("cpu")
    bases = torch.from_numpy(posed.bases_from_pose_track(
        np.array([[0.0, 0.0, 0.0], [10.0, 20.0, 30.0]]))).float()
    src = torch.from_numpy(rng.integers(0, 256, (B, 6 * S * S), dtype=np.uint8))
    bg = torch.zeros((hb, wb), dtype=torch.uint8)
    n0, c0 = static_ray.static_ray_posed.launches, static_ray.static_ray_posed.cube_launches
    args = (src, t, bases, g, S, *GRID, False, bg, 1)
    torch.testing.assert_close(static_ray.static_ray_posed(*args),
                               static_ray.static_ray_posed_plain(*args), rtol=0, atol=0)
    assert (static_ray.static_ray_posed.launches,
            static_ray.static_ray_posed.cube_launches) == (n0, c0)


def _signed_axis(v):
    """(axis, sign) of a signed-axis frame vector."""
    a = int(np.flatnonzero(v)[0])
    return a, np.float32(v[a])


def cube_pick_twin(globe, x, y, z, lens_valid):
    """The kernel's cube resolve in float32 NumPy on unit rays ``x, y, z``
    -> (plate, valid, px, py) as :func:`rays_to_lensmap_torch` reports
    them (plate -1 and px, py 0 where invalid)."""
    fwd, rgt, up = (np.asarray(a, np.float32) for a in (globe.forward, globe.right, globe.up))
    dists = plate_dists_f32(globe)
    facing = {_signed_axis(f): p for p, f in enumerate(fwd)}  # (axis, sign) -> plate
    comps = (x, y, z)
    m = np.fmax(np.fmax(np.abs(x), np.abs(y)), np.abs(z))
    pc = np.full(x.shape, 5, np.int32)
    for a, c in enumerate(comps):
        p = np.where(np.signbit(c), facing[(a, np.float32(-1))], facing[(a, np.float32(1))])
        pc = np.minimum(pc, np.where(np.abs(c) == m, p, 5))
    rz = m
    rx = np.zeros_like(x)
    ry = np.zeros_like(x)
    dist = np.zeros_like(x)
    for p in range(6):
        sel = pc == p
        (ar, sr), (au, su) = _signed_axis(rgt[p]), _signed_axis(up[p])
        rx = np.where(sel, sr * comps[ar], rx)
        ry = np.where(sel, su * comps[au], ry)
        dist = np.where(sel, dists[p], dist)
    with np.errstate(all="ignore"):
        u = (rx / rz) * dist + np.float32(0.5)
        v = (-ry / rz) * dist + np.float32(0.5)
        uv_valid = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        px = np.where(uv_valid, u * np.float32(S), 0).astype(np.int32)
        py = np.where(uv_valid, v * np.float32(S), 0).astype(np.int32)
    valid = lens_valid & uv_valid & (px >= 0) & (px < S) & (py >= 0) & (py < S)
    return (np.where(valid, pc, -1), valid, np.where(valid, px, 0), np.where(valid, py, 0))


# rays that tie between faces (|x| = |y| = |z|, two equal magnitudes of
# either sign), rays with +-0 components, and the odd rays of the card
# tests: zero, NaN, inf, underflowing, denormal and huge
TIE_RAYS = [(1.0, 0.0, 1.0), (-1.0, 0.0, -1.0), (1.0, 0.0, -1.0), (-1.0, 0.0, 1.0),
            (1.0, 1.0, 1.0), (-1.0, -1.0, -1.0), (1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
            (0.0, 1.0, 1.0), (0.0, -1.0, 1.0), (1.0, 1.0, 0.0), (-1.0, -1.0, 0.0),
            (-0.0, 0.0, 1.0), (0.0, -0.0, -1.0), (-0.0, 1.0, -0.0), (0.5, -0.0, 0.5),
            (-0.0, -0.0, -0.0), (3.0, -3.0, 0.0), (1e-30, 1e-30, 1e-30)]
ODD_RAYS = [(0.0, 0.0, 0.0), (np.nan, 0.3, 1.0), (np.inf, 0.0, 1.0), (0.0, -np.inf, np.inf),
            (1e-30, 0.0, 0.0), (0.0, 0.0, -1.0), (1e-20, 0.0, 1e-20), (3e-39, -1e-21, 2e-45),
            (1e19, -1e19, 1e19), (-4e-39, 0.0, 1e-38), (-np.inf, np.inf, 0.0),
            (np.nan, np.nan, np.nan), (3e38, 3e38, -3e38)]


def _exact_bases(kind):
    """Bases whose products tie faces exactly: the identity, a 90-degree
    yaw (entries 0 and +-1), a 45-degree yaw (entries +-sqrt(1/2) in
    float32), and one that turns the forward axis onto the cube's corner
    direction (1, 1, 1) / sqrt(3)."""
    if kind == "identity":
        b = [[[0, 0, 1], [1, 0, 0], [0, 1, 0]]]
    elif kind == "yaw90":
        b = [[[1, 0, 0], [0, 0, -1], [0, 1, 0]], [[-1, 0, 0], [0, 0, 1], [0, 1, 0]]]
    elif kind == "yaw45":
        s = float(np.float32(np.sqrt(0.5)))
        b = [[[s, 0, s], [s, 0, -s], [0, 1, 0]], [[-s, 0, s], [s, 0, s], [0, 1, 0]]]
    else:
        c = float(np.float32(1 / np.sqrt(3)))
        b = [[[c, c, c], [c, -c, c], [-c, c, c]]]
    return torch.tensor(b, dtype=torch.float32)


def _rays(kind, seed):
    """[H, W] ray planes: seeded normal rays with the tie and odd rays
    planted in them (the grid 7 x 9)."""
    rng = np.random.default_rng(seed)
    vx, vy, vz = (rng.normal(size=(7, 9)).astype(np.float32) for _ in range(3))
    planted = {"seeded": [], "ties": TIE_RAYS, "odd": ODD_RAYS}[kind]
    for i, ray in enumerate(planted):
        vx.flat[i], vy.flat[i], vz.flat[i] = ray
    lens_valid = np.ones(vx.shape, bool)
    lens_valid.flat[-1] = False
    return vx, vy, vz, lens_valid


def _bases(pose_kind, seed):
    if pose_kind == "seeded":
        rng = np.random.default_rng(seed)
        poses = np.stack([rng.uniform(-90, 90, 16), rng.uniform(0, 360, 16),
                          rng.uniform(-45, 45, 16)], 1)
        return torch.from_numpy(posed.bases_from_pose_track(poses)).float()
    return _exact_bases(pose_kind)


@pytest.mark.parametrize("globe_name", ["cube", "relabelled", "turned"])
@pytest.mark.parametrize("ray_kind", ["seeded", "ties", "odd"])
@pytest.mark.parametrize("pose_kind", ["seeded", "identity", "yaw90", "yaw45", "corner"])
def test_cube_pick_twin_equals_max_dot(globe_name, ray_kind, pose_kind):
    """The twin of kCube's pick and rays_to_lensmap_torch's max-dot select
    give the same plate, validity, px and py on every ray and pose."""
    g = dict((c[0], c[1]) for c in CHOICES)[globe_name]()
    assert cube_resolver(g)
    vx, vy, vz, lens_valid = _rays(ray_kind, seed=len(pose_kind))
    bases = _bases(pose_kind, seed=len(ray_kind))
    want = rays_to_lensmap_torch(g, *(torch.from_numpy(a) for a in (vx, vy, vz, lens_valid)),
                                 S, *GRID, view_basis=bases)
    x, y, z = (t.numpy() for t in rotate_normalize_torch(
        *(torch.from_numpy(a) for a in (vx, vy, vz)), bases))
    plate, valid, px, py = cube_pick_twin(g, x, y, z, lens_valid)
    for name, got in (("plate", plate), ("valid", valid), ("px", px), ("py", py)):
        np.testing.assert_array_equal(got, want[name].numpy(), err_msg=name)
    if ray_kind != "odd":
        assert valid.any()


def test_cube_pick_twin_sees_the_ties():
    """The tie rays do tie: on the identity pose several have two or three
    components of the largest magnitude, and the first plate in plate order
    wins, which decides validity on a cube edge: (1, 0, 1) goes to the
    front plate, where it falls on the right edge (u rounds to 1, px = S,
    invalid), while the right plate would take it at u = 0; (-1, 0, -1)
    goes to the left plate, not the back, at u = 0."""
    vx, vy, vz, lens_valid = _rays("ties", seed=0)
    x, y, z = (t.numpy() for t in rotate_normalize_torch(
        *(torch.from_numpy(a) for a in (vx, vy, vz)), _exact_bases("identity")))
    mags = np.stack([np.abs(x[0]), np.abs(y[0]), np.abs(z[0])])
    ties = (mags == mags.max(0)).sum(0)
    assert (ties.flat[:12] >= 2).all() and (ties.flat[4:8] == 3).all()
    plate = cube_pick_twin(globes.get("cube"), x[0], y[0], z[0], lens_valid)[0]
    assert plate.flat[0] == -1 and plate.flat[1] == 2


SASS = """
        Function : _Z6kernelILi0EEvPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;      /* 0x00000a0000017a02 */
        /*0010*/                   FMUL R2, R3, R4 ;           /* 0x0000000403027220 */
        /*0020*/                   EXIT ;                      /* 0x000000000000794d */
        Function : _Z6kernelILi3EEvPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;      /* 0x00000a0000017a02 */
        /*0010*/                   FMNMX R2, |R3|, |R4|, !PT ; /* 0x4000000403027209 */
        /*0020*/                   EXIT ;                      /* 0x000000000000794d */
"""


def test_bench_posed_compares_sass_function_by_function():
    """``bench/posed.py --against``'s comparison: a function is the same
    where every instruction is, whatever its addresses; the others differ
    or are in one build only."""
    from blinky_tpu_torch.bench import posed as bench_posed

    here = bench_posed.sass_functions(SASS)
    assert [t for _, t in here["_Z6kernelILi3EEvPf"]][1] == "FMNMX R2, |R3|, |R4|, !PT"
    other = bench_posed.sass_functions(SASS.replace("FMUL R2, R3, R4", "FMUL R2, R4, R3")
                                       .replace("_Z6kernelILi3EEvPf", "_Z6kernelILi2EEvPf"))
    assert bench_posed.compare_sass(here, here) == (sorted(here), [], [], [])
    assert bench_posed.compare_sass(here, other) == (
        [], ["_Z6kernelILi0EEvPf"], ["_Z6kernelILi3EEvPf"], ["_Z6kernelILi2EEvPf"])
    moved = {n: [(a + 0x100, t) for a, t in ins] for n, ins in here.items()}
    assert bench_posed.compare_sass(here, moved)[0] == sorted(here)
    # another build's anonymous namespace hash is not a difference
    a = {"_ZN40_GLOBAL__N__7ca55619_8_posed_cu_1bf06c8023kIhEEv": here["_Z6kernelILi0EEvPf"]}
    b = {"_ZN40_GLOBAL__N__e4195d66_8_posed_cu_1bf06c8023kIhEEv": here["_Z6kernelILi0EEvPf"]}
    assert bench_posed.compare_sass(a, b) == (
        ["_ZN40_GLOBAL__N__8_posed_cu_1bf06c8023kIhEEv"], [], [], [])
