"""Dual-backend math shim: one source of truth for lens/globe formulas.

The reference evaluates lens math in Lua doubles through libm
(``engine/NQ/fisheye.c:1222-1265`` preloads ``cos``/``sin``/``tan``/... as
Lua globals).  Every projection formula is written once against this
module, as in :mod:`blinky_tpu.xmath`, and runs under two backends:

* **NumPy float64**: the exact host builder.  The float64 transcendentals
  route through glibc libm, bit-identical to the JAX package's host
  builder.
* **torch**: the float32 device builder (:mod:`blinky_tpu_torch.lensmap`),
  eager tensor operations on whatever device the tensors lie on.

Dispatch rule: if any argument is a tensor, use ``torch``; otherwise
``np``.  Python scalars follow NumPy (load-time metadata math, mirroring
the Lua scripts' top-level code).  A Python scalar that meets a tensor
takes the tensor's dtype, as a weakly typed scalar does under jax.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_torch(a) -> bool:
    return isinstance(a, torch.Tensor)


def xp(*args):
    """Return the array namespace (``np`` or ``torch``) governing *args*."""
    return torch if any(_is_torch(a) for a in args) else np


def _tensors(*args):
    """*args* with every non-tensor made a 0-d tensor of the dtype and
    device of the first tensor among them (torch's binary functions, unlike
    its operators, take no Python scalars)."""
    ref = next(a for a in args if _is_torch(a))
    return tuple(a if _is_torch(a) else torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                 for a in args)


# The reference's lens math is Lua 5.2 doubles, and Lua's math.* are raw
# glibc libm calls — but NumPy's SIMD float64 transcendentals differ from
# glibc by 1 ulp on a few percent of inputs.  The float64 path therefore
# routes through an elementwise libm loop in the native library; float32
# arrays keep NumPy's vectorized paths.
_LIBM_UNARY = {
    "sin": 0, "cos": 1, "tan": 2, "arcsin": 3, "arccos": 4, "arctan": 5,
    "sinh": 6, "cosh": 7, "tanh": 8, "log": 9, "log10": 10, "exp": 11,
    "sqrt": 12,
}
_LIBM_BINARY = {"arctan2": 0, "fmod": 1, "power": 2, "hypot": 3}
_TORCH_NAMES = {"power": "pow"}  # torch has every other name, NumPy's aliases too
_native = None


def _libm():
    global _native
    if _native is None:
        from blinky_tpu_torch import native

        _native = native
    return _native


def _wants_libm(*arrs) -> bool:
    return all(a.dtype.kind in "iuf" and a.dtype != np.float32 for a in arrs)


def _match_shape(out, x):
    if isinstance(x, np.ndarray) and x.ndim:
        return out
    return np.float64(out[()])  # scalar in -> scalar out, as np ufuncs do


def _unary(name):
    op = _LIBM_UNARY.get(name)

    def f(x):
        if _is_torch(x):
            return getattr(torch, name)(x)
        if op is not None:
            arr = np.asarray(x)
            if _wants_libm(arr):
                out = _libm().libm_unary(op, arr)
                if out is not None:
                    return _match_shape(out, x)
        return getattr(np, name)(x)

    f.__name__ = name
    return f


def _binary(name):
    op = _LIBM_BINARY.get(name)

    def f(a, b):
        if _is_torch(a) or _is_torch(b):
            return getattr(torch, _TORCH_NAMES.get(name, name))(*_tensors(a, b))
        if op is not None:
            aa, bb = np.asarray(a), np.asarray(b)
            if _wants_libm(aa, bb):
                a2, b2 = np.broadcast_arrays(aa, bb)
                out = _libm().libm_binary(op, a2, b2)
                if out is not None:
                    out = out.reshape(a2.shape)
                    if isinstance(a, np.ndarray) and a.ndim or isinstance(b, np.ndarray) and b.ndim:
                        return out
                    return np.float64(out[()])
        return getattr(np, name)(a, b)

    f.__name__ = name
    return f


sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
asin = _unary("arcsin")
acos = _unary("arccos")
atan = _unary("arctan")
sinh = _unary("sinh")
cosh = _unary("cosh")
tanh = _unary("tanh")
log = _unary("log")
log10 = _unary("log10")
exp = _unary("exp")
sqrt = _unary("sqrt")
abs = _unary("abs")  # noqa: A001 - mirrors the Lua alias table
floor = _unary("floor")
trunc = _unary("trunc")
sign = _unary("sign")

atan2 = _binary("arctan2")
fmod = _binary("fmod")
maximum = _binary("maximum")
minimum = _binary("minimum")
power = _binary("power")
hypot = _binary("hypot")

pi = float(np.pi)
tau = 2.0 * float(np.pi)


def where(c, a, b):
    if xp(c, a, b) is np:
        return np.where(c, a, b)
    if not _is_torch(c):
        c = torch.as_tensor(c, device=next(t for t in (a, b) if _is_torch(t)).device)
    # two Python scalars under a tensor condition give torch's default
    # dtype, float32: the build dtype, never float64
    return torch.where(c, a, b)


def modf(x):
    """Lua ``math.modf``: returns (integer part toward zero, fractional part).

    NumPy's modf returns (frac, int) — swapped to Lua's (int, frac) order
    since the lens scripts (``lenses/cube.lua:14-16``) destructure that way.
    """
    if _is_torch(x):
        intg = torch.trunc(x)
        # C's modf: x - trunc(x) is exact, an infinite x has a zero fraction,
        # and the fraction carries the sign of x even where it is zero
        frac = torch.where(torch.isinf(x), torch.zeros_like(x), x - intg)
        return intg, torch.copysign(frac, x)
    frac, intg = np.modf(x)
    return intg, frac


def safe_div(a, b, fill=0.0):
    """a/b with b==0 mapped to *fill* — keeps branches finite where the
    Lua relies on IEEE inf/nan propagation being discarded by a later
    ``where``/nil check."""
    zero = b == 0
    return where(zero, fill, a / where(zero, 1.0, b))


def repeat_until(body, state, max_iter):
    """Vectorized Lua ``repeat ... until`` with per-element exit.

    The reference's iterative solvers (``mollweide.lua:12-20``,
    ``winkeltripel.lua:38-77``) run a scalar loop per pixel whose exit
    depends on the data.  Vectorized, each element keeps updating until its
    own exit condition fires, then freezes — exactly equivalent to the
    per-pixel scalar loop.

    Args:
        body: ``body(state_tuple) -> (new_state_tuple, exit_bool_array)``.
            Must be shape-preserving and ELEMENTWISE over the state — any
            captured per-element array must ride in the state tuple,
            because the working set is compacted to the still-active
            elements each round.  A body that captures full-size arrays in
            its closure still works: the compacted call raises a shape
            error and the loop restarts densely.
        state: tuple of arrays (broadcast to a common shape internally).
        max_iter: iteration cap (NumPy exits early once all elements have
            exited; on tensors a masked dense loop runs, see
            :func:`_repeat_until_torch`).
    Returns:
        The final state tuple.
    """
    if xp(*state) is torch:
        return _repeat_until_torch(body, state, max_iter)
    # Active-set evaluation: each round runs the body only on the elements
    # that have not exited.  Bit-exact vs the dense masked loop: bodies are
    # elementwise, so every element sees the identical op sequence until
    # its own exit.
    state = tuple(np.asarray(s, dtype=np.result_type(s, np.float64)) for s in state)
    shape = np.broadcast_shapes(*[s.shape for s in state])
    try:
        flat = [np.broadcast_to(s, shape).reshape(-1).copy() for s in state]
        idx = np.arange(flat[0].size)
        work = tuple(f[idx] for f in flat)
        for _ in range(max_iter):
            if idx.size == 0:
                break
            new_state, ex = body(work)
            new_state = tuple(np.broadcast_to(n, idx.shape) for n in new_state)
            for f, n in zip(flat, new_state):
                f[idx] = n
            keep = ~np.broadcast_to(np.asarray(ex), idx.shape)
            idx = idx[keep]
            work = tuple(n[keep] for n in new_state)
        return tuple(f.reshape(shape) for f in flat)
    except (ValueError, IndexError):
        # A body that captures full-size arrays in its closure breaks once
        # the working set shrinks; bodies are pure, so restart with the
        # dense masked loop.
        st = tuple(np.broadcast_to(s, shape).copy() for s in state)
        active = np.ones(shape, dtype=bool)
        for _ in range(max_iter):
            if not active.any():
                break
            new_state, ex = body(st)
            st = tuple(np.where(active, np.broadcast_to(n, shape), o)
                       for n, o in zip(new_state, st))
            active &= ~np.broadcast_to(np.asarray(ex), shape)
        return st


def _repeat_until_torch(body, state, max_iter):
    """:func:`repeat_until` on tensors: the masked dense loop of *max_iter*
    rounds, the counterpart of the JAX package's ``fori_loop``.  Every round
    evaluates the body on all elements and keeps the old value of those that
    have exited, so a frozen element is never updated and the result equals
    the per-element scalar loop.  No round asks the device whether any
    element is still active: the question would wait for the device."""
    state = torch.broadcast_tensors(*_tensors(*state))
    active = torch.ones(state[0].shape, dtype=torch.bool, device=state[0].device)
    for _ in range(max_iter):
        new_state, ex = body(state)
        state = tuple(torch.where(active, n, o) for n, o in zip(new_state, state))
        active = active & ~ex
    return state


def asarray_like(value, ref):
    """Make *value* an array of the backend and dtype of *ref*."""
    if _is_torch(ref):
        return torch.as_tensor(value, dtype=ref.dtype, device=ref.device)
    return np.asarray(value, dtype=getattr(ref, "dtype", None))
