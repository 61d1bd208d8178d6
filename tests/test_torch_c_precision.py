"""The C mixed-precision helpers of the port (blinky_tpu_torch.geometry)
against blinky_tpu.geometry's, bit for bit.

The reference stores rays and plate frames in float32 (``vec3_t``),
normalizes in float32 with a double square root truncated to float32,
selects plates by float32 dot products, and projects onto a plate in double
(SURVEY.md's "hard parts"; tests/test_c_precision.py pins the JAX package's
emulation to those semantics).  The port's copies must give the same bits
on the same inputs: ``normalize_c``, ``ray_to_plate_index_c``,
``plate_uv_to_ray_c`` (on NumPy arrays and, as ``lenses.make_context``
calls it, on tensors), ``ray_to_plate_uv_c`` and ``latlon_to_ray_f32``.
The inputs are random float32 rays and frames made from a seed with NumPy,
with the edges added: a zero ray, a NaN ray, rays that tie between two
plates, rays perpendicular to a plate (``rz == 0``) and rays whose ``u`` or
``v`` lands exactly on 0 or 1.  Tolerance 0 throughout; a NaN equals a NaN.
"""

import numpy as np
import pytest
import torch

from blinky_tpu import geometry as jgeometry
from blinky_tpu import globes as jglobes
from blinky_tpu_torch import geometry, globes

F32, F64 = np.float32, np.float64
N = 400


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b)


def _random_frames(rng, n):
    """*n* plate frames as the globe loader makes them (float32 cross
    products, no normalisation) from random forwards and ups, and float32
    fovs of 5-175 degrees."""
    fwd = rng.normal(size=(n, 3))
    up = rng.normal(size=(n, 3))
    forward, right, up2 = geometry.plate_frames(fwd, up)
    fov = rng.uniform(5, 175, n) * np.pi / 180
    return forward, right, up2, fov.astype(F32)


def _rays(seed):
    """[N] float32 rays: random directions and lengths, then the edges: a
    zero ray, a NaN ray, an infinite one, a denormal one."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(N, 3)) * rng.uniform(0.01, 100, (N, 1))
    v[0] = 0.0
    v[1] = (np.nan, 0.5, 1.0)
    v[2] = (np.inf, 0.0, 1.0)
    v[3] = (1e-40, -2e-41, 3e-45)
    v = v.astype(F32)
    return v[:, 0].copy(), v[:, 1].copy(), v[:, 2].copy()


@pytest.mark.parametrize("name", jglobes.names())
def test_plate_frames_are_float32(name):
    """Every built-in globe's frames, fovs and distances are float32, as the
    reference's ``vec_t``, and equal the JAX package's."""
    assert globes.names() == jglobes.names()
    g, jg = globes.get(name), jglobes.get(name)
    for f in ("forward", "right", "up", "fov_rad", "dist"):
        a, b = getattr(g, f), getattr(jg, f)
        assert a.dtype == np.float32, (name, f, a.dtype)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_normalize_c_bit_equal(seed):
    """NumPy and tensor branches, the square root in double (the C) and in
    float32 (the float32 builder's): a zero ray stays zero, a NaN spreads."""
    x, y, z = _rays(seed)
    for sq_np, sq_t in ((F64, torch.float64), (F32, torch.float32)):
        want = jgeometry.normalize_c(x, y, z, np, F32, sq_np)
        _equal(geometry.normalize_c(x, y, z, np, F32, sq_np), want)
        _equal(geometry.normalize_c(*map(torch.from_numpy, (x, y, z)), torch, torch.float32,
                                    sq_t), want)
    zero = geometry.normalize_c(x[:1], y[:1], z[:1], np, F32, F64)
    assert all(c[0] == 0 for c in zero)
    nan = geometry.normalize_c(x[1:2], y[1:2], z[1:2], np, F32, F64)
    assert all(np.isnan(c[0]) for c in nan)


@pytest.mark.parametrize("numplates", [1, 2, 4, 6])
def test_ray_to_plate_index_c_bit_equal_and_first_wins_ties(numplates):
    """Random frames and rays, and rays that tie: plate 1 repeats plate 0's
    forward (every dot ties) and rays along the bisector of two orthogonal
    forwards dot both alike.  The first plate wins each tie."""
    rng = np.random.default_rng(numplates)
    forward, _, _, _ = _random_frames(rng, numplates)
    x, y, z = _rays(numplates)
    _equal([geometry.ray_to_plate_index_c(x, y, z, forward, np)],
           [jgeometry.ray_to_plate_index_c(x, y, z, forward, np)])
    if numplates < 2:
        return
    tied = forward.copy()
    tied[1] = tied[0]
    got = geometry.ray_to_plate_index_c(x, y, z, tied, np)
    _equal([got], [jgeometry.ray_to_plate_index_c(x, y, z, tied, np)])
    assert not (got == 1).any()
    axes = np.eye(3, dtype=F32)[[2, 0, 1]][:numplates].copy()  # +z, +x, +y
    bz = rng.uniform(0.1, 2, 8).astype(F32)
    bx = bz.copy()  # x == z: the +z and +x dots are equal
    by = np.zeros(8, F32)
    got = geometry.ray_to_plate_index_c(bx, by, bz, axes, np)
    _equal([got], [jgeometry.ray_to_plate_index_c(bx, by, bz, axes, np)])
    assert (got == 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_ray_to_plate_uv_c_bit_equal(seed):
    """Each ray on the plate its index selects (frames gathered per ray, as
    the builders gather them) and on one plate for all rays: u, v and the
    valid mask bit-equal, NaN for NaN."""
    rng = np.random.default_rng(10 + seed)
    forward, right, up, fov = _random_frames(rng, 6)
    x, y, z = _rays(seed)
    plate = geometry.ray_to_plate_index_c(x, y, z, forward, np)
    args = (x, y, z, forward[plate], right[plate], up[plate], fov[plate], F64)
    got = geometry.ray_to_plate_uv_c(*args)
    _equal(got, jgeometry.ray_to_plate_uv_c(*args))
    assert got[2].any() and not got[2].all()
    for p in range(6):
        args = (x, y, z, forward[p], right[p], up[p], fov[p], F64)
        _equal(geometry.ray_to_plate_uv_c(*args), jgeometry.ray_to_plate_uv_c(*args))


def test_ray_to_plate_uv_c_edges():
    """rz == 0 (a ray perpendicular to the forward), a zero and a NaN ray
    are invalid; u and v exactly on 0 and 1 are valid (closed interval),
    one float32 step past them is not.  The edges are exact with a plate of
    fov 2^-40: tan(2^-41) rounds to 2^-41, so dist = 2^40, and a ray
    (2^-41, 0, 1) gives u = 2^-41 * 2^40 + 0.5 = 1."""
    e = F32(2.0 ** -41)
    past = np.nextafter(e, F32(1))
    rays = np.array([
        (1, 0, 0), (0, 1, 0), (0, 0, 0), (np.nan, 0, 1),   # rz == 0, zero, NaN
        (e, 0, 1), (-e, 0, 1), (0, e, 1), (0, -e, 1),      # u = 1, 0; v = 0, 1
        (e, e, 1), (-e, -e, 1),                            # corners
        (past, 0, 1), (-past, 0, 1), (0, past, 1), (0, -past, 1),
        (0, 0, 1), (0, 0, -1), (e, 0, -1),                 # the centre, behind
    ], F32)
    x, y, z = (rays[:, i].copy() for i in range(3))
    fwd, rgt, up = (np.eye(3, dtype=F32)[i] for i in (2, 0, 1))
    fov = F32(2.0 ** -40)
    args = (x, y, z, fwd, rgt, up, fov, F64)
    u, v, ok = geometry.ray_to_plate_uv_c(*args)
    _equal((u, v, ok), jgeometry.ray_to_plate_uv_c(*args))
    np.testing.assert_array_equal(u[4:10], [1, 0, 0.5, 0.5, 1, 0])
    np.testing.assert_array_equal(v[4:10], [0.5, 0.5, 0, 1, 0, 1])
    np.testing.assert_array_equal(
        ok, [False] * 4 + [True] * 6 + [False] * 4 + [True] * 3)
    # behind the plate (rz < 0) the projection flips through the centre and
    # is valid, as in the C, which never tests rz's sign (the plate index
    # keeps a ray off the plates behind it)
    np.testing.assert_array_equal(u[14:], [0.5, 0.5, 0])


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("seed", range(2))
def test_plate_uv_to_ray_c_bit_equal_numpy_and_tensor(seed, dtype):
    """The NumPy branch and the tensor branch, called as
    ``lenses.make_context``'s ``plate_to_ray`` calls them (the frames of
    each element's plate, the square root in double for double uv and in
    float32 for float32 uv), on random uv with the edges 0, 1 and 0.5, and
    on every plate of a random globe."""
    rng = np.random.default_rng(20 + seed)
    forward, right, up, fov = _random_frames(rng, 6)
    dist = geometry.plate_dist(fov.astype(F64)).astype(F32)
    u = rng.uniform(-0.2, 1.2, N)
    v = rng.uniform(-0.2, 1.2, N)
    u[:6], v[:6] = (0, 1, 0.5, 0, 1, 0.5), (0, 1, 0.5, 1, 0, 0)
    u, v = u.astype(dtype), v.astype(dtype)
    i = rng.integers(0, 6, N)
    sq_np, sq_t = (F64, torch.float64) if dtype == F64 else (F32, torch.float32)
    frames = (forward[i], right[i], up[i], dist[i])
    want = jgeometry.plate_uv_to_ray_c(u, v, *frames, np, F32, sq_np)
    _equal(geometry.plate_uv_to_ray_c(u, v, *frames, np, F32, sq_np), want)
    got = geometry.plate_uv_to_ray_c(torch.from_numpy(u), torch.from_numpy(v),
                                     *map(torch.from_numpy, frames), torch, torch.float32,
                                     sq_t)
    assert all(c.dtype == torch.float32 for c in got)
    _equal(got, want)
    # and back: the ray of a plate's uv selects a plate and projects as the
    # JAX package's does
    x, y, z = want
    plate = geometry.ray_to_plate_index_c(x, y, z, forward, np)
    args = (x, y, z, forward[plate], right[plate], up[plate], fov[plate], F64)
    _equal(geometry.ray_to_plate_uv_c(*args), jgeometry.ray_to_plate_uv_c(*args))


def test_latlon_to_ray_f32_bit_equal():
    """Scalars (the zoom probe's and the lens metadata's calls) and arrays,
    the poles and the seam among them; every component is a float32 value."""
    rng = np.random.default_rng(4)
    lat = np.concatenate([rng.uniform(-np.pi / 2, np.pi / 2, N),
                          [np.pi / 2, -np.pi / 2, 0.0, 0.3]])
    lon = np.concatenate([rng.uniform(-np.pi, np.pi, N), [0.0, np.pi, np.pi, 2.9]])
    got = geometry.latlon_to_ray_f32(lat, lon)
    _equal(got, jgeometry.latlon_to_ray_f32(lat, lon))
    for c in got:
        np.testing.assert_array_equal(c, c.astype(F32).astype(F64))
    for a, b in zip(lat[-6:], lon[-6:]):
        s, js = geometry.latlon_to_ray_f32(float(a), float(b)), jgeometry.latlon_to_ray_f32(
            float(a), float(b))
        for c, jc in zip(s, js, strict=True):
            assert type(c) is type(jc) is np.float64 and c == jc
