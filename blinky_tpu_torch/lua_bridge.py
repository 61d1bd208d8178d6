"""Load the reference's ``.lua`` lens/globe scripts as drop-ins.

The port of :mod:`blinky_tpu.lua_bridge`: the framework's
``LUA_load_lens`` / ``LUA_load_globe`` (``engine/NQ/fisheye.c:1659-1875``).
A script runs in a fresh :mod:`blinky_tpu_torch.minilua` environment with
the host builtins the C embeds (``init_lua``, ``fisheye.c:1222-1265``), and
the resulting globals become a :class:`blinky_tpu_torch.lenses.LensDef` or
a :class:`blinky_tpu_torch.globes.Globe`.

The builtins reproduce the C<->Lua boundary exactly:

* ``latlon_to_ray`` passes through a ``vec3_t`` — float32-truncated
  components (``CtoLUA_latlon_to_ray``, ``fisheye.c:1494-1505``);
* ``ray_to_latlon`` truncates its inputs to float32 and evaluates the
  sum of squares in float32 (``fisheye.c:1506-1519`` + the ``vec_t``
  arithmetic in ``ray_to_latlon``);
* ``plate_to_ray`` projects through the float32 ``plate_uv_to_ray`` and
  returns nil for an out-of-range plate (``fisheye.c:1521-1538``);
* lens functions returning nil mean "no pixel"
  (``LUAtoC_lens_inverse/forward``, ``fisheye.c:1545-1628``).

Execution is hybrid, as in the JAX package: NumPy array calls (the exact
float64 host builder) run through the masked vectorized evaluator
(:mod:`blinky_tpu_torch.lua_vector`, bit-equal to the scalar
interpreter), falling back to the scalar ``np.vectorize`` path for scalar
inputs or for the script construct that needs per-lane control flow.

Tensor inputs (the float32 device builder, ``render_posed``'s lens stage,
a script globe's resolver on the device) evaluate through the same
evaluator in its tensor mode (:class:`_TracedLua`), so ``.lua`` drop-ins
take every device path a built-in lens or globe takes.  ``jittable`` (the
JAX package's name: here it means "evaluates on tensors") is decided at
load by one run on a tiny CPU float32 tensor grid; a script that needs
per-lane control stays on the exact host path.  A script that passed that
run and fails on the card raises: nothing falls back.
"""

from __future__ import annotations

import math
import threading
from pathlib import Path

import numpy as np
import torch

from blinky_tpu_torch import geometry
from blinky_tpu_torch import xmath as xm
from blinky_tpu_torch.lua_vector import Unvectorizable, VectorInterpreter, _MaybeNil
from blinky_tpu_torch.minilua import Interpreter, LuaError, LuaTable
from blinky_tpu_torch.palette import MAX_PLATES


def _scalar_latlon_to_ray(lat, lon):
    """CtoLUA_latlon_to_ray: double math through a vec3_t (f32)."""
    clat = math.cos(lat)
    return (
        float(np.float32(math.sin(lon) * clat)),
        float(np.float32(math.sin(lat))),
        float(np.float32(math.cos(lon) * clat)),
    )


def _scalar_ray_to_latlon(x, y, z):
    """CtoLUA_ray_to_latlon: f32 inputs, f32 sum of squares, double atan2."""
    x32, y32, z32 = np.float32(x), np.float32(y), np.float32(z)
    lon = math.atan2(float(x32), float(z32))
    lat = math.atan2(float(y32), math.sqrt(float(x32 * x32 + z32 * z32)))
    return lat, lon


def _is_vec(*vs) -> bool:
    return any(isinstance(v, np.ndarray) and v.ndim > 0 for v in vs)


def _f32round(v):
    """The vec3_t pass-through: double -> float -> double, per element."""
    return np.asarray(v, np.float64).astype(np.float32).astype(np.float64)


def _is_tensor(*vs) -> bool:
    return any(isinstance(v, torch.Tensor) for v in vs)


def _vector_latlon_to_ray(lat, lon):
    """Array CtoLUA_latlon_to_ray, elementwise-identical to the scalar
    one (xmath routes f64 transcendentals through the same glibc libm
    Python's ``math`` calls).  Tensor inputs take the float32 builder's
    path, :func:`blinky_tpu_torch.geometry.latlon_to_ray_f32`."""
    if _is_tensor(lat, lon):
        return geometry.latlon_to_ray_f32(*_tensors(lat, lon))
    if not _is_vec(lat, lon):
        return _scalar_latlon_to_ray(lat, lon)
    clat = xm.cos(lat)
    return (_f32round(xm.sin(lon) * clat), _f32round(xm.sin(lat)),
            _f32round(xm.cos(lon) * clat))


def _vector_ray_to_latlon(x, y, z):
    if _is_tensor(x, y, z):
        return geometry.ray_to_latlon(*_tensors(x, y, z))  # the f32 builder's path
    if not _is_vec(x, y, z):
        return _scalar_ray_to_latlon(x, y, z)
    x32 = np.asarray(x, np.float64).astype(np.float32)
    y32 = np.asarray(y, np.float64).astype(np.float32)
    z32 = np.asarray(z, np.float64).astype(np.float32)
    lon = xm.atan2(x32.astype(np.float64), z32.astype(np.float64))
    s = x32 * x32 + z32 * z32  # the vec_t (f32) sum of squares
    lat = xm.atan2(y32.astype(np.float64), xm.sqrt(s.astype(np.float64)))
    return lat, lon


def _tensors(*vs):
    """*vs* as tensors of one shape: a number becomes a tensor of the
    dtype and device of the first tensor among them."""
    return torch.broadcast_tensors(*xm._tensors(*vs))


def _plate_frames(globe, device):
    """The globe's float32 plate frames and distances as tensors."""
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (globe.forward, globe.right, globe.up, globe.dist))


def make_lua_builtins(globe=None, vector=False) -> dict:
    """The host symbols a script sees (``fisheye.c:254-260,1258-1265``).

    With ``vector=True`` the converters accept arrays and tensors (for the
    vectorized evaluator); scalar calls behave identically either way.
    """

    def plate_to_ray(i, u, v):
        if globe is None:
            return None
        if _is_tensor(i):
            # a lane-varying plate index on tensors (debug.lua): gather
            # the per-lane plate frames and project, the formulation of
            # the built-in debug lens (lenses.make_context's
            # plate_to_ray).  Out-of-range lanes clip; they are per-lane
            # nil (lua_pushnil, fisheye.c:1528-1531), one mask for the
            # triple.
            i, u, v = _tensors(i, u, v)
            f64 = torch.float64 if u.dtype == torch.float64 else torch.float32
            tr = torch.trunc(i)  # the C (int) cast
            valid = (tr >= 0) & (tr < globe.numplates)  # NaN -> False
            ii = torch.clamp(torch.nan_to_num(tr, nan=0.0), 0,
                             globe.numplates - 1).to(torch.int64)
            fwd, rgt, up, dist = (a[ii] for a in _plate_frames(globe, u.device))
            out = geometry.plate_uv_to_ray_c(u, v, fwd, rgt, up, dist, torch,
                                              torch.float32, f64)
            nil = ~valid
            return tuple(_MaybeNil(c, nil) for c in out)
        if _is_vec(i):
            # lane-varying plate index on the np whole-grid path
            # (debug.lua): gather each lane's plate frame — per lane
            # identical arithmetic to the scalar-plate branch below, so
            # bit-equal to per-pixel scalar calls.  Out-of-range lanes
            # are per-lane nil (lua_pushnil, fisheye.c:1528-1531),
            # carried as one shared-mask _MaybeNil triple.  (A NaN
            # plate on an ACTIVE lane would error per-pixel on the
            # scalar path; here it maps to nil — garbage on merged-out
            # lanes is routinely NaN and must not refuse the grid.)
            ii = np.asarray(i, np.float64)
            with np.errstate(invalid="ignore"):
                tr = np.trunc(np.nan_to_num(ii, nan=-1.0))  # C int() cast
                valid = (tr >= 0) & (tr < globe.numplates)
            idx = np.clip(tr, 0, globe.numplates - 1).astype(np.int64)
            rx, ry, rz = geometry.plate_uv_to_ray_c(
                np.asarray(u, np.float64), np.asarray(v, np.float64),
                globe.forward[idx], globe.right[idx], globe.up[idx],
                globe.dist[idx], np, np.float32, np.float64,
            )
            out = (np.asarray(rx, np.float64), np.asarray(ry, np.float64),
                   np.asarray(rz, np.float64))
            if bool(valid.all()):
                return out
            nil = ~valid  # ONE mask object: slots share it (nil protocol)
            return tuple(_MaybeNil(c, nil) for c in out)
        pi = int(np.asarray(i)[()] if isinstance(i, np.ndarray) else i)
        if pi < 0 or pi >= globe.numplates:
            return None  # lua_pushnil, fisheye.c:1528-1531
        if _is_tensor(u, v):
            # the float32 builder's boundary (the sqrt precision follows
            # the input dtype, as in the builder)
            u, v = _tensors(u, v)
            f64 = torch.float64 if u.dtype == torch.float64 else torch.float32
            fwd, rgt, up, dist = (a[pi] for a in _plate_frames(globe, u.device))
            return geometry.plate_uv_to_ray_c(u, v, fwd, rgt, up, dist, torch,
                                              torch.float32, f64)
        if _is_vec(u, v):
            rx, ry, rz = geometry.plate_uv_to_ray_c(
                np.asarray(u, np.float64), np.asarray(v, np.float64),
                globe.forward[pi], globe.right[pi], globe.up[pi],
                globe.dist[pi], np, np.float32, np.float64,
            )
            return (np.asarray(rx, np.float64), np.asarray(ry, np.float64),
                    np.asarray(rz, np.float64))
        rx, ry, rz = geometry.plate_uv_to_ray_c(
            np.float64(u), np.float64(v),
            globe.forward[pi], globe.right[pi], globe.up[pi],
            globe.dist[pi], np, np.float32, np.float64,
        )
        return float(rx), float(ry), float(rz)

    out = dict(
        latlon_to_ray=_vector_latlon_to_ray if vector else _scalar_latlon_to_ray,
        ray_to_latlon=_vector_ray_to_latlon if vector else _scalar_ray_to_latlon,
        plate_to_ray=plate_to_ray,
    )
    if globe is not None:
        out["numplates"] = float(globe.numplates)
    return out


# the probe grid: 3 x 4 float32 lanes spread over a lens plane's range
_PROBE = np.linspace(-1.5, 1.5, 12, dtype=np.float32).reshape(3, 4)


class _TracedLua:
    """Evaluate a script function on tensors (the JAX package's traced
    evaluator; the name is kept).

    A FRESH interpreter runs the script per call, for the JAX package's
    reason: no state from an earlier evaluation may leak through mutated
    globals (eckert4's memoized row, quincuncial's AGM tables).  Top-level
    code runs with concrete scalars exactly as at load time; only the lens
    function's arguments are tensors, so the evaluator's tensor semantics
    engage just for the lane math."""

    def __init__(self, src, globe):
        self.src = src
        self.globe = globe

    def call(self, name, args, nout):
        """-> tuple of ``nout`` tensors + a bool validity tensor, on the
        arguments' device."""
        it = VectorInterpreter(
            builtins=make_lua_builtins(self.globe, vector=True))
        it.run(self.src)
        fn = it.get_global(name)
        if fn is None:
            raise Unvectorizable(f"{name} not defined")
        args = _tensors(*args)
        vals, nil = it.vcall(fn, list(args))
        ref = args[0]
        shape = tuple(ref.shape)
        if len(vals) == 0:  # uniformly nil
            z = torch.zeros(shape, dtype=ref.dtype, device=ref.device)
            return (z,) * nout + (torch.zeros(shape, dtype=torch.bool, device=ref.device),)
        if len(vals) != nout:
            raise LuaError(f"{name} must return {nout} numbers or nil")
        ok = (torch.ones(shape, dtype=torch.bool, device=ref.device) if nil is None
              else ~torch.broadcast_to(nil, shape))
        return tuple(torch.broadcast_to(torch.as_tensor(v, dtype=None if isinstance(
            v, torch.Tensor) else ref.dtype, device=ref.device), shape)
            for v in vals) + (ok,)

    def probe(self, name, nargs, nout) -> bool:
        """Does *name* evaluate on tensors?  One run on a tiny CPU float32
        grid at load (the JAX package's abstract probe): the tensor mode
        never inspects a lane, so what it decides here holds for any
        grid.  Decides ``LensDef.jittable``."""
        try:
            args = [torch.from_numpy(_PROBE.copy())] * nargs
            self.call(name, args, nout)
            return True
        except Exception:
            return False


class _ScalarFallback:
    """Lazily built scalar-interpreter twin of a script (used for
    scalar inputs and after an :class:`Unvectorizable`).  Captures the
    SOURCE at load time: the file may be edited or deleted before the
    fallback first engages, and a fresh interpreter guarantees globals
    half-mutated by an aborted vectorized run never leak in."""

    def __init__(self, src, globe):
        self.src = src
        self.globe = globe
        self._interp = None

    def get(self, name):
        if self._interp is None:
            self._interp = Interpreter(
                builtins=make_lua_builtins(self.globe))
            self._interp.run(self.src)
        return self._interp.get_global(name)

    def close(self):
        """Unwind any coroutine threads the script parked in the scalar
        interpreter (a suspended coroutine pins an OS thread whose frame
        references the interpreter, so GC alone can never reclaim it).
        Idempotent; the fallback rebuilds lazily if used again."""
        if self._interp is not None:
            self._interp.close()
            self._interp = None


def _vectorize_inverse(luafn, vinterp, fallback, traced=None,
                       vector_ok=True, lock=None):
    """Wrap a Lua ``lens_inverse`` into the array contract
    ``(x, y) -> (vx, vy, vz, valid)`` with the LUAtoC nil protocol.

    Tensor inputs (the device builder, the posed path's lens stage) run
    through a fresh tensor evaluator; NumPy array inputs go through the
    masked vectorized evaluator; scalar inputs (and scripts that raise
    Unvectorizable — *vector_ok=False* when that already happened at load
    time) use the per-element scalar interpreter.

    *lock* serializes the host paths: the load-time ``vinterp`` and the
    lazily-built scalar ``fallback`` interpreter are shared mutable state,
    and concurrent host builds are real (a ``render_posed(block=False)``
    background table build racing the caller's thread).  The tensor path
    needs no lock (a fresh interpreter per call, ``_TracedLua.call``)."""
    state = {"vector_ok": vector_ok}
    lock = lock if lock is not None else threading.RLock()

    def scalar(x, y):
        out = fallback.get("lens_inverse")(float(x), float(y))
        if out is None:
            return 0.0, 0.0, 0.0, False
        if not (isinstance(out, tuple) and len(out) == 3):
            raise LuaError("lens_inverse must return 3 numbers or nil")
        return float(out[0]), float(out[1]), float(out[2]), True

    vec = np.vectorize(scalar, otypes=[np.float64, np.float64, np.float64, bool])

    def inverse(x, y):
        if _is_tensor(x, y):
            return traced.call("lens_inverse", (x, y), 3)
        with lock:
            X = np.asarray(x, np.float64)
            Y = np.asarray(y, np.float64)
            if state["vector_ok"] and (X.ndim or Y.ndim):
                try:
                    with np.errstate(all="ignore"):
                        vals, nil = vinterp.vcall(luafn, [X, Y])
                    shape = np.broadcast(X, Y).shape
                    if len(vals) == 0:  # uniformly nil
                        z = np.zeros(shape)
                        return z, z, z, np.zeros(shape, bool)
                    if len(vals) != 3:
                        raise LuaError("lens_inverse must return 3 numbers or nil")
                    ok = (np.ones(shape, bool) if nil is None
                          else ~np.broadcast_to(nil, shape))
                    return (np.broadcast_to(vals[0], shape),
                            np.broadcast_to(vals[1], shape),
                            np.broadcast_to(vals[2], shape), ok)
                except (Unvectorizable, TypeError):
                    # TypeError: an array reached a scalar-only builtin —
                    # same verdict as Unvectorizable, use the scalar walk
                    state["vector_ok"] = False  # permanent scalar fallback
            return vec(x, y)

    return inverse


def _vectorize_forward(luafn, vinterp, fallback, traced=None,
                       vector_ok=True, lock=None):
    state = {"vector_ok": vector_ok}
    lock = lock if lock is not None else threading.RLock()

    def scalar(x, y, z):
        out = fallback.get("lens_forward")(float(x), float(y), float(z))
        if out is None:
            return 0.0, 0.0, False
        if not (isinstance(out, tuple) and len(out) == 2):
            raise LuaError("lens_forward must return 2 numbers or nil")
        return float(out[0]), float(out[1]), True

    vec = np.vectorize(scalar, otypes=[np.float64, np.float64, bool])

    def forward(x, y, z):
        if _is_tensor(x, y, z):
            return traced.call("lens_forward", (x, y, z), 2)
        with lock:
            X = np.asarray(x, np.float64)
            if state["vector_ok"] and (X.ndim or np.asarray(y).ndim
                                       or np.asarray(z).ndim):
                try:
                    with np.errstate(all="ignore"):
                        vals, nil = vinterp.vcall(luafn, [
                            X, np.asarray(y, np.float64),
                            np.asarray(z, np.float64)])
                    shape = np.broadcast(X, np.asarray(y), np.asarray(z)).shape
                    if len(vals) == 0:
                        zz = np.zeros(shape)
                        return zz, zz, np.zeros(shape, bool)
                    if len(vals) != 2:
                        raise LuaError("lens_forward must return 2 numbers or nil")
                    ok = (np.ones(shape, bool) if nil is None
                          else ~np.broadcast_to(nil, shape))
                    return (np.broadcast_to(vals[0], shape),
                            np.broadcast_to(vals[1], shape), ok)
                except (Unvectorizable, TypeError):
                    state["vector_ok"] = False
            return vec(x, y, z)

    return forward


def load_lua_lens(path, globe=None):
    """Run a ``lenses/*.lua`` script and resolve it like ``LUA_load_lens``."""
    from blinky_tpu_torch.lenses import resolve

    path = Path(path)
    src = path.read_text()
    interp = VectorInterpreter(builtins=make_lua_builtins(globe, vector=True))
    try:
        interp.run(src)
        reader, vector_ok = interp, True
    except Unvectorizable:
        # the script uses a scalar-authority construct at LOAD time
        # (e.g. goto): the whole lens runs on the per-element scalar
        # engine — still a working drop-in, just the slow tier
        reader = Interpreter(builtins=make_lua_builtins(globe))
        reader.run(src)
        vector_ok = False
    fallback = _ScalarFallback(src, globe)
    traced = _TracedLua(src, globe)

    spec = {}
    inv = reader.get_global("lens_inverse")
    fwd = reader.get_global("lens_forward")
    # ONE lock for both maps: they share interp + fallback (their
    # interpreter state must never interleave across threads)
    script_lock = threading.RLock()
    if inv is not None:
        spec["lens_inverse"] = _vectorize_inverse(inv, interp, fallback,
                                                  traced,
                                                  vector_ok=vector_ok,
                                                  lock=script_lock)
    if fwd is not None:
        spec["lens_forward"] = _vectorize_forward(fwd, interp, fallback,
                                                  traced,
                                                  vector_ok=vector_ok,
                                                  lock=script_lock)
    # jittable iff the map driving the builder evaluates on tensors.
    # Forward-only lenses rasterize on the host either way, so only the
    # inverse map gates device builds.
    spec["jittable"] = (inv is None
                        or traced.probe("lens_inverse", 2, 3))
    for name in ("map", "onload"):
        v = reader.get_global(name)
        if v is not None:
            spec[name] = v
    for name in ("max_fov", "max_vfov", "lens_width", "lens_height"):
        v = reader.get_global(name)
        if isinstance(v, np.ndarray) and v.ndim == 0:
            v = float(v)
        if isinstance(v, (int, float)):
            spec[name] = v

    # release hook: a script may leave a coroutine SUSPENDED at load
    # time (e.g. a generator parked at its second yield) — that pins one
    # OS thread whose frame references the interpreter, unreclaimable by
    # GC.  Only the SCALAR interpreters can hold one (the vector engine
    # refuses coroutine.create outright), so unwind the scalar reader
    # (Unvectorizable tier) and the lazy fallback when the owner is done
    # with the lens (Session calls this on lens-cache eviction).
    def _release():
        if reader is not interp:  # the scalar-tier reader
            reader.close()
        fallback.close()

    spec["release"] = _release
    return resolve(path.stem, spec)


def _tensor_plates(vals, nil, shape, device):
    """A script resolver's result on tensors -> int32 plates: nil and NaN
    lanes are -1 (``LUAtoC_globe_plate``, ``fisheye.c:1645-1649``), the
    rest truncate.  Values clamp to [-1, MAX_PLATES] first, which keeps
    every use of a plate (``plate >= 0`` and its clip to the globe's
    plates) and keeps huge values out of the integer cast."""
    if len(vals) == 0:
        return torch.full(shape, -1, dtype=torch.int32, device=device)
    v = vals[0]
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(float(v), dtype=torch.float64, device=device)
    v = torch.broadcast_to(v, shape)
    v = torch.where(torch.isnan(v), -1.0, v).clamp(-1.0, float(MAX_PLATES))
    out = torch.trunc(v).to(torch.int32)
    if nil is not None:
        out = torch.where(torch.broadcast_to(nil, shape), -1, out).to(torch.int32)
    return out


def load_lua_globe(path):
    """Run a ``globes/*.lua`` script and build the Globe like
    ``LUA_load_globe`` (``fisheye.c:1752-1875``)."""
    from blinky_tpu_torch.globes import make_globe

    path = Path(path)
    src = path.read_text()
    interp = VectorInterpreter(builtins=make_lua_builtins(None, vector=True))
    vector_ok = True
    try:
        interp.run(src)
    except Unvectorizable:
        # scalar-authority construct at load time: re-run on the scalar
        # engine (the globe_plate resolver then uses only the
        # per-element fallback)
        interp = Interpreter(builtins=make_lua_builtins(None))
        interp.run(src)
        vector_ok = False

    plates_t = interp.get_global("plates")
    if not isinstance(plates_t, LuaTable):
        raise LuaError(f"globe script {path.name}: 'plates' table not found")
    plates = []
    for row in plates_t.array():
        if not isinstance(row, LuaTable):
            raise LuaError("plates entries must be {forward, up, fov} tables")
        fwd_t, up_t, fov = row.get(1), row.get(2), row.get(3)
        if not (isinstance(fwd_t, LuaTable) and isinstance(up_t, LuaTable)
                and isinstance(fov, (int, float))):
            raise LuaError("plate must be {{fx,fy,fz},{ux,uy,uz},fov}")
        plates.append((tuple(fwd_t.array()), tuple(up_t.array()), float(fov)))

    resolver = None
    gp = interp.get_global("globe_plate")
    if gp is not None:
        state = {"vector_ok": vector_ok}
        fallback = _ScalarFallback(src, None)  # fresh interpreter: an
        # aborted vectorized run must not leak half-merged globals
        # serialize the shared interp/fallback across threads (same
        # reasoning as load_lua_lens's script_lock)
        script_lock = threading.RLock()

        def scalar(x, y, z):
            out = fallback.get("globe_plate")(float(x), float(y), float(z))
            if out is None or isinstance(out, bool) or not isinstance(out, (int, float)):
                return -1  # non-number -> no plate (fisheye.c:1645-1649)
            return int(out)

        vec = np.vectorize(scalar, otypes=[np.int32])

        def resolver(x, y, z, globe):  # noqa: F811 - the exported resolver
            if _is_tensor(x, y, z):
                # LUAtoC_globe_plate on tensors, a fresh interpreter a call
                x, y, z = _tensors(x, y, z)
                it = VectorInterpreter(
                    builtins=make_lua_builtins(None, vector=True))
                it.run(src)
                vals, nil = it.vcall(it.get_global("globe_plate"), [x, y, z])
                return _tensor_plates(vals, nil, tuple(x.shape), x.device)
            with script_lock:
                X = np.asarray(x, np.float64)
                Y = np.asarray(y, np.float64)
                Z = np.asarray(z, np.float64)
                if state["vector_ok"] and (X.ndim or Y.ndim or Z.ndim):
                    try:
                        with np.errstate(all="ignore"):
                            vals, nil = interp.vcall(gp, [X, Y, Z])
                        shape = np.broadcast(X, Y, Z).shape
                        if len(vals) == 0:
                            return np.full(shape, -1, np.int32)
                        v = np.broadcast_to(vals[0], shape)
                        out = np.trunc(np.where(np.isnan(v), -1, v)).astype(np.int32)
                        if nil is not None:
                            out = np.where(np.broadcast_to(nil, shape),
                                           np.int32(-1), out)
                        return out
                    except (Unvectorizable, TypeError):
                        state["vector_ok"] = False
                return vec(X, Y, Z)

    # a globe evaluates on the device iff its resolver does (the lens-side
    # LensDef.jittable analog): probed at load, so the builder and Session
    # route scalar-only globes to the exact host path
    g_jittable = True
    if resolver is not None:
        if not vector_ok:
            g_jittable = False
        else:
            try:
                probe = torch.from_numpy(_PROBE.copy())
                resolver(probe, probe, probe, None)
            except Exception:
                g_jittable = False
    return make_globe(path.stem, plates, plate_resolver=resolver,
                      jittable=g_jittable)
