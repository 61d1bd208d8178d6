"""The port's math shim and geometry (blinky_tpu_torch.xmath, .geometry)
against blinky_tpu's, function by function.

* The NumPy float64 branch must equal ``blinky_tpu.xmath`` bit for bit
  (tolerance 0): both route through glibc libm.
* The torch branch is held to the jax.numpy branch on the same float32
  inputs, made from a seed with NumPy.  Tolerances, stated per function:
  0 for the functions both evaluate exactly (abs, floor, trunc, sign,
  maximum, minimum, fmod, where, modf, safe_div); ``TRANSCENDENTAL`` = 4
  float32 ulps of the larger of |result| and 1 for the transcendentals,
  whose last bits differ between torch's and XLA:CPU's implementations,
  and for sqrt, which torch rounds correctly and XLA:CPU does not always
  (an ulp off on 0.6 % of these inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import geometry as jgeometry
from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu import xmath as jm
from blinky_tpu_torch import geometry, globes, lenses
from blinky_tpu_torch import xmath as m

ULP = float(np.finfo(np.float32).eps)
TRANSCENDENTAL = 4 * ULP

# name -> (input range, exact?)
UNARY = {
    "sin": ((-4.0, 4.0), False), "cos": ((-4.0, 4.0), False), "tan": ((-1.4, 1.4), False),
    "asin": ((-1.0, 1.0), False), "acos": ((-1.0, 1.0), False), "atan": ((-50.0, 50.0), False),
    "sinh": ((-5.0, 5.0), False), "cosh": ((-5.0, 5.0), False), "tanh": ((-5.0, 5.0), False),
    "log": ((1e-3, 1e3), False), "log10": ((1e-3, 1e3), False), "exp": ((-10.0, 10.0), False),
    "sqrt": ((0.0, 1e4), False), "abs": ((-9.0, 9.0), True), "floor": ((-9.0, 9.0), True),
    "trunc": ((-9.0, 9.0), True), "sign": ((-9.0, 9.0), True),
}
BINARY = {
    "atan2": False, "fmod": True, "maximum": True, "minimum": True, "power": False,
    "hypot": False,
}


def _inputs(lo, hi, seed, n=4001):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, n)
    x[:3] = (lo, hi, 0.0 if lo <= 0.0 <= hi else lo)
    return x


def _close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert (err <= TRANSCENDENTAL * np.maximum(np.abs(want), 1.0)).all(), err.max()


@pytest.mark.parametrize("name", list(UNARY))
def test_unary_numpy_bit_equal_and_torch_close(name):
    (lo, hi), exact = UNARY[name]
    x = _inputs(lo, hi, len(name))
    a, b = getattr(m, name)(x), getattr(jm, name)(x)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    s, js = getattr(m, name)(float(x[7])), getattr(jm, name)(float(x[7]))
    assert type(s) is type(js) and s == js  # scalar in, scalar out
    x32 = x.astype(np.float32)
    got = getattr(m, name)(torch.from_numpy(x32))
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), getattr(jm, name)(jnp.asarray(x32)), exact)


@pytest.mark.parametrize("name", list(BINARY))
def test_binary_numpy_bit_equal_and_torch_close(name):
    x = _inputs(-6.0, 6.0, 1)
    y = _inputs(0.1, 6.0, 2) if name == "power" else _inputs(-6.0, 6.0, 3)
    if name == "power":
        x = np.abs(x) + 0.1
    np.testing.assert_array_equal(getattr(m, name)(x, y), getattr(jm, name)(x, y))
    np.testing.assert_array_equal(getattr(m, name)(x, 1.5), getattr(jm, name)(x, 1.5))
    assert getattr(m, name)(2.5, 1.5) == getattr(jm, name)(2.5, 1.5)
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    got = getattr(m, name)(torch.from_numpy(x32), torch.from_numpy(y32))
    _close(got.numpy(), getattr(jm, name)(jnp.asarray(x32), jnp.asarray(y32)), BINARY[name])
    # a Python scalar beside a tensor takes the tensor's dtype, either side
    for args, jargs in (((torch.from_numpy(x32), 1.5), (jnp.asarray(x32), 1.5)),
                        ((1.5, torch.from_numpy(y32)), (1.5, jnp.asarray(y32)))):
        got = getattr(m, name)(*args)
        assert got.dtype == torch.float32
        _close(got.numpy(), getattr(jm, name)(*jargs), BINARY[name])


def test_xp_where_modf_safe_div_asarray_like():
    x = _inputs(-3.0, 3.0, 5)
    x[3:6] = (np.inf, -np.inf, -0.0)
    t = torch.from_numpy(x.astype(np.float32))
    j = jnp.asarray(x.astype(np.float32))
    assert m.xp(x, 2.0) is np and m.xp(1.0) is np and m.xp(x, t) is torch
    assert m.pi == jm.pi and m.tau == jm.tau
    # where: arrays, scalars and a tensor condition over two Python scalars
    np.testing.assert_array_equal(m.where(x > 0, x, 0.5), jm.where(x > 0, x, 0.5))
    _close(m.where(t > 0, t, 0.5).numpy(), jm.where(j > 0, j, 0.5), True)
    two = m.where(t > 0, 0.5, -0.5)
    assert two.dtype == torch.float32  # the build dtype, never float64
    _close(two.numpy(), jm.where(j > 0, 0.5, -0.5).astype(jnp.float32), True)
    assert m.where(t > 0, 1, 0).dtype == torch.int64
    # modf: Lua's (integer part, fraction) order
    for got, want in zip(m.modf(x), jm.modf(x)):
        np.testing.assert_array_equal(got, want)
    # on tensors: C's modf, as NumPy's (an infinite x has a zero fraction of
    # its sign); jax.numpy agrees on every finite input
    finite = np.isfinite(x)
    for got, want, jwant in zip(m.modf(t), m.modf(x.astype(np.float32)), jm.modf(j)):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(np.signbit(got.numpy()), np.signbit(want))
        _close(got.numpy()[finite], np.asarray(jwant)[finite], True)
    # safe_div: b == 0 maps to the fill
    b = x.copy()
    b[::7] = 0.0
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(m.safe_div(x, b), jm.safe_div(x, b))
        np.testing.assert_array_equal(m.safe_div(x, b, fill=7.0), jm.safe_div(x, b, fill=7.0))
    tb, jb = torch.from_numpy(b.astype(np.float32)), jnp.asarray(b.astype(np.float32))
    _close(m.safe_div(t, tb).numpy(), jm.safe_div(j, jb), True)
    got = m.asarray_like(2.5, t)
    assert got.dtype == torch.float32 and got.device == t.device and float(got) == 2.5
    assert m.asarray_like(2.5, x).dtype == jm.asarray_like(2.5, x).dtype


def _newton_body(state):
    """mollweide's solver body (lenses/mollweide.py): its exit is signed."""
    t, lat = state
    mod = m if isinstance(t, (np.ndarray, torch.Tensor)) else jm
    dt = -(t + mod.sin(t) - mod.pi * mod.sin(lat)) / (1 + mod.cos(t))
    return (t + dt, lat), dt < 0.001


def _count_body(state):
    """Integer-valued state: exact on every backend.  x doubles until it
    passes its own threshold; n counts the rounds an element was live."""
    x, n, thr = state
    return (x * 2, n + 1, thr), x * 2 > thr


def test_repeat_until_numpy_bit_equal():
    lat = _inputs(-1.5, 1.5, 9, n=500)
    got = m.repeat_until(_newton_body, (lat, lat), max_iter=100)
    want = jm.repeat_until(_newton_body, (lat, lat), max_iter=100)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_repeat_until_torch_freezes_at_own_exit():
    """The tensor loop freezes an element at its own exit, like the scalar
    loop: integer-valued states equal the NumPy branch and the JAX branch
    exactly."""
    rng = np.random.default_rng(11)
    thr = rng.integers(1, 5000, (7, 9)).astype(np.float32)
    x0 = np.ones_like(thr)
    n0 = np.zeros_like(thr)
    want = m.repeat_until(_count_body, (x0, n0, thr), max_iter=10)  # NumPy branch
    jwant = jm.repeat_until(_count_body, tuple(jnp.asarray(a) for a in (x0, n0, thr)),
                            max_iter=10)
    got = m.repeat_until(_count_body, tuple(torch.from_numpy(a) for a in (x0, n0, thr)),
                         max_iter=10)
    for g, w, jw in zip(got, want, jwant):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jw))
    assert got[1].max() == 10  # some elements never exit: the cap holds them
    # a scalar beside tensors broadcasts into the state
    got = m.repeat_until(_count_body, (1.0, torch.from_numpy(n0), torch.from_numpy(thr)), 10)
    np.testing.assert_array_equal(got[0].numpy(), want[0])


def test_repeat_until_torch_newton_close_to_jax():
    """mollweide's Newton solve on tensors is within the transcendental
    tolerance of the JAX branch."""
    lat = _inputs(-1.5, 1.5, 9, n=500).astype(np.float32)
    t, _ = m.repeat_until(_newton_body, (torch.from_numpy(lat),) * 2, max_iter=100)
    jt, _ = jm.repeat_until(_newton_body, (jnp.asarray(lat),) * 2, max_iter=100)
    # a solve that exits a round earlier or later on one side moves t by up
    # to the exit threshold, 0.001; the Newton step contracts it to far less
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-4)


def test_geometry_numpy_bit_equal_and_torch_close():
    rng = np.random.default_rng(3)
    lat, lon = rng.uniform(-1.5, 1.5, 300), rng.uniform(-3.1, 3.1, 300)
    for a, b in zip(geometry.latlon_to_ray(lat, lon), jgeometry.latlon_to_ray(lat, lon)):
        np.testing.assert_array_equal(a, b)
    ray = geometry.latlon_to_ray(lat, lon)
    for a, b in zip(geometry.ray_to_latlon(*ray), jgeometry.ray_to_latlon(*ray)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(geometry.normalize(*ray), jgeometry.normalize(*ray)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(geometry.latlon_to_ray_f32(lat, lon), jgeometry.latlon_to_ray_f32(lat, lon)):
        np.testing.assert_array_equal(a, b)
    f32 = lambda *xs: [x.astype(np.float32) for x in xs]  # noqa: E731
    lat32, lon32 = f32(lat, lon)
    tl, tn = torch.from_numpy(lat32), torch.from_numpy(lon32)
    jl, jn = jnp.asarray(lat32), jnp.asarray(lon32)
    tray, jray = geometry.latlon_to_ray(tl, tn), jgeometry.latlon_to_ray(jl, jn)
    for a, b in zip(tray, jray):
        _close(a.numpy(), b, False)
    # on the same float32 rays
    rays = [np.array(c) for c in jray]
    trays = [torch.from_numpy(c) for c in rays]
    for a, b in zip(geometry.ray_to_latlon(*trays), jgeometry.ray_to_latlon(*jray)):
        _close(a.numpy(), b, False)
    for a, b in zip(geometry.normalize(*[3 * c for c in trays]),
                    jgeometry.normalize(*[3 * c for c in jray])):
        _close(a.numpy(), b, False)
    for a, b in zip(geometry.latlon_to_ray_f32(tl, tn), jgeometry.latlon_to_ray_f32(jl, jn)):
        _close(a.numpy(), b, False)
    # normalize_c: float32 sums, the sqrt in the asked precision, a zero ray
    # left as it is, a NaN length spreading
    x, y, z = (rng.uniform(-2, 2, 300) for _ in range(3))
    x[:2], y[:2], z[:2] = (0.0, np.nan), (0.0, 1.0), (0.0, 1.0)
    for sq_np, sq_t in ((np.float32, torch.float32), (np.float64, torch.float64)):
        want = jgeometry.normalize_c(x, y, z, np, np.float32, sq_np)
        got_np = geometry.normalize_c(x, y, z, np, np.float32, sq_np)
        got = geometry.normalize_c(*(torch.from_numpy(c) for c in (x, y, z)), torch,
                                   torch.float32, sq_t)
        for a, b, c in zip(got, got_np, want):
            np.testing.assert_array_equal(b, c)
            np.testing.assert_array_equal(a.numpy(), c)  # IEEE sqrt and division: exact


@pytest.mark.parametrize("globe_name", ["cube", "tetra"])
def test_plate_to_ray_numpy_bit_equal_and_torch_close(globe_name):
    """make_context's plate_to_ray (CtoLUA_plate_to_ray) and
    plate_uv_to_ray_c: the NumPy branch equals blinky_tpu's bit for bit; the
    tensor branch (float32 products, sums, a square root, a division) is
    within the transcendental tolerance of the jax.numpy branch, whose sums
    XLA:CPU contracts and whose sqrt it does not round correctly."""
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    jctx, ctx = jlenses.make_context(jg), lenses.make_context(g)
    assert ctx.numplates == jctx.numplates
    rng = np.random.default_rng(8)
    i = rng.integers(0, g.numplates, 200)
    u, v = rng.uniform(0, 1, 200), rng.uniform(0, 1, 200)
    for a, b in zip(ctx.plate_to_ray(i, u, v), jctx.plate_to_ray(i, u, v)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ctx.plate_to_ray(2, u, v), jctx.plate_to_ray(2, u, v)):
        np.testing.assert_array_equal(a, b)
    u32, v32 = u.astype(np.float32), v.astype(np.float32)
    got = ctx.plate_to_ray(torch.from_numpy(i), torch.from_numpy(u32), torch.from_numpy(v32))
    want = jctx.plate_to_ray(jnp.asarray(i), jnp.asarray(u32), jnp.asarray(v32))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        _close(a.numpy(), b, False)
    got = ctx.plate_to_ray(1, torch.from_numpy(u32), torch.from_numpy(v32))
    want = jctx.plate_to_ray(1, jnp.asarray(u32), jnp.asarray(v32))
    for a, b in zip(got, want):
        _close(a.numpy(), b, False)
