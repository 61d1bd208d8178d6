"""K14: a script globe's plate resolver compiled to one CUDA kernel.

A script globe's ``globe_plate`` evaluates on tensors through the Lua
evaluator's tensor mode (``lua_vector.py``), or a ``.py`` globe's own
torch code: about 30 elementwise library kernels a call, each reading and
writing whole float32 or bool planes.  Under ``jit`` XLA fused the JAX
package's trace of the same code; eager PyTorch does not.  So:

1. :func:`record` runs the resolver once on a few float32 rays under a
   ``TorchFunctionMode`` and keeps what it issues as a :class:`Tape`, an
   SSA list of elementwise operations on per-ray values: the inputs,
   constants as torch made them, and one node an operation.  Only a closed
   set of operations records (arithmetic, compares, logical operations,
   ``where``, ``abs``, ``isnan``, ``trunc``/``floor``/``ceil``, ``clamp``
   with number bounds, casts, fills, and views that only broadcast); any
   other call, and any that reads a value back (a data-dependent loop's
   ``any``, ``item``, ``bool``, a lane-keyed table read's indexing),
   makes the script not tapeable (:class:`NotTapeable`).  The evaluator
   never inspects a lane otherwise, so what one recording issues holds
   for every ray.
2. :func:`cuda_source` writes the tape as straight-line CUDA C++, each
   float operation an IEEE intrinsic (``__fadd_rn``, ``__fmul_rn``,
   ``__fdiv_rn``...), so that no product is fused into a sum as torch's
   kernels never fuse them, and the library is built with ``--fmad=false``
   as well.  A division by a host number runs as torch runs it on a card,
   a product by its float reciprocal.
3. :func:`script_tape` launches it (``blinky_script_tape``, one thread a
   run of four rays): K13's three float32 planes in, the int8 plates out,
   clamped to [-1, MAX_PLATES] as ``script_pose_plates`` clamps them.  Its
   plain version, for tensors on the CPU, is :func:`replay`, the tape's
   operations issued again with torch.

The library is named by a hash of its source and built into
``blinky_tpu_torch/build/`` with :func:`_build.compile_locked`, so a
checkout builds each script's once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import threading
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.lensmap.builder import script_plates
from blinky_tpu_torch.lua_vector import Unvectorizable
from blinky_tpu_torch.minilua import LuaError
from blinky_tpu_torch.palette import MAX_PLATES
from blinky_tpu_torch.utils.timing import span

# the C type of each dtype a tape may hold
CTYPES = {torch.bool: "bool", torch.int8: "signed char", torch.int32: "int",
          torch.int64: "long long", torch.float32: "float", torch.float64: "double"}
FLOATS = (torch.float32, torch.float64)
# the rays a recording evaluates on: a prime count, so that no table of the
# script has their shape by chance
PROBE_RAYS = 29
# K14's own flags beside the kernel library's: no product fused into a sum
NVCC_FLAGS = ["--fmad=false"]


class NotTapeable(Exception):
    """The resolver issues an operation a tape cannot hold."""


@dataclasses.dataclass(frozen=True)
class Scalar:
    """A Python number operand (torch's wrapped number)."""

    value: object  # bool, int or float


@dataclasses.dataclass(frozen=True)
class Node:
    """One value a ray: ``op`` on ``args`` (node indices or
    :class:`Scalar`), of ``dtype``; ``lanes`` False for a 0-d value.
    ``compute`` is the dtype a compare's operands meet in; a ``const``
    holds ``value`` (an ``input``, its ray plane's index), and ``host`` marks a 0-d tensor on the host beside
    device operands (a division by it runs as a product by its
    reciprocal on a card)."""

    op: str
    args: tuple
    dtype: torch.dtype
    lanes: bool = True
    compute: torch.dtype | None = None
    value: object = None
    host: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class Tape:
    """A resolver's operations on the rays ``(x, y, z)``: ``nodes[0:3]``
    are the inputs and ``nodes[out]`` the int8 plate."""

    nodes: tuple
    out: int

    @functools.cached_property
    def source(self) -> str:
        return cuda_source(self)

    @functools.cached_property
    def digest(self) -> str:
        return hashlib.sha256(self.source.encode()).hexdigest()[:16]


# ------------------------------------------------------------- recording

# the operations a tape holds, by the name torch calls them by
_ALIASES = {
    "add": ("add", "__add__", "__radd__"),
    "sub": ("sub", "__sub__", "subtract"),
    "rsub": ("rsub", "__rsub__"),
    "mul": ("mul", "__mul__", "__rmul__", "multiply"),
    "div": ("div", "__truediv__", "__div__", "true_divide", "divide"),
    "rdiv": ("__rtruediv__", "__rdiv__"),
    "neg": ("neg", "__neg__", "negative"),
    "abs": ("abs", "__abs__", "absolute"),
    "trunc": ("trunc", "fix"),
    "floor": ("floor",),
    "ceil": ("ceil",),
    "reciprocal": ("reciprocal",),
    "isnan": ("isnan",),
    "lt": ("lt", "__lt__", "less"),
    "le": ("le", "__le__", "less_equal"),
    "gt": ("gt", "__gt__", "greater"),
    "ge": ("ge", "__ge__", "greater_equal"),
    "eq": ("eq", "__eq__"),
    "ne": ("ne", "__ne__", "not_equal"),
    "and": ("__and__", "__rand__", "bitwise_and"),
    "or": ("__or__", "__ror__", "bitwise_or"),
    "xor": ("__xor__", "__rxor__", "bitwise_xor"),
    "not": ("__invert__", "bitwise_not"),
    "where": ("where",),
    "clamp": ("clamp", "clip"),
    "cast": ("to", "type", "float", "double", "int", "long", "bool", "char"),
    "alias": ("contiguous", "clone", "detach", "broadcast_to", "expand", "expand_as",
              "broadcast_tensors"),
    "fill": ("full", "zeros", "ones", "full_like", "zeros_like", "ones_like", "scalar_tensor",
             "tensor", "as_tensor"),
}
_OPS = {name: op for op, names in _ALIASES.items() for name in names}
_ARITH = ("add", "sub", "mul", "div")
_UNARY = ("neg", "abs", "trunc", "floor", "ceil", "reciprocal")
_COMPARES = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_BITWISE = {"and": "&", "or": "|", "xor": "^"}
# calls that read metadata, not values
_META = {".shape", ".dtype", ".device", ".ndim", ".is_cuda", ".layout", ".requires_grad",
         "is_floating_point", "is_complex", "dim", "size", "numel", "is_contiguous",
         "element_size", "get_device", "result_type"}


def _name(func) -> str:
    name = getattr(func, "__name__", "")
    if name == "__get__":  # a property of a tensor
        return "." + getattr(getattr(func, "__self__", None), "__name__", "?")
    return name


def _number(v):
    """*v* as a Python bool, int or float, or None if it is no number."""
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return None


class _Recorder(TorchFunctionMode):
    """Keeps each torch call of the evaluation as a node; the first call a
    tape cannot hold sets ``refused``, and the evaluation runs on
    untouched (its own control flow decides nothing here)."""

    def __init__(self, inputs):
        super().__init__()
        self.shape = tuple(inputs[0].shape)
        self.device = inputs[0].device
        self.nodes = []
        self.ids = {}  # id(tensor) -> node
        self.alive = []  # every tensor bound, so that no id is reused
        self.refused = None
        for i, t in enumerate(inputs):
            self._bind(t, self._add(Node("input", (), torch.float32, value=i)))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.refused is None:
            try:
                self._record(_name(func), func, args, kwargs, out)
            except NotTapeable as e:
                self.refused = str(e)
        return out

    def _add(self, node) -> int:
        if node.dtype not in CTYPES:
            raise NotTapeable(f"a value of dtype {node.dtype}")
        self.nodes.append(node)
        return len(self.nodes) - 1

    def _bind(self, t, n) -> None:
        self.ids[id(t)] = n
        self.alive.append(t)

    def _lanes(self, t) -> bool:
        if tuple(t.shape) == self.shape:
            return True
        if t.dim() == 0:
            return False
        raise NotTapeable(f"a value of shape {tuple(t.shape)} beside rays of {self.shape}")

    def operand(self, a):
        """A node index or a :class:`Scalar` for argument *a*."""
        if isinstance(a, torch.Tensor):
            n = self.ids.get(id(a))
            if n is not None:
                return n
            if a.dim() == 0:  # a 0-d tensor made before the recording
                return self._const(a)
            raise NotTapeable("a tensor that the evaluation did not make")
        v = _number(a)
        if v is None:
            raise NotTapeable(f"an operand of type {type(a).__name__}")
        return Scalar(v)

    def _const(self, t) -> int:
        flat = t.detach().reshape(-1)
        if flat.numel() == 0:
            raise NotTapeable("an empty tensor")
        bits = flat.view(torch.uint8) if t.dtype == torch.bool else flat.view(
            {1: torch.int8, 4: torch.int32, 8: torch.int64}[t.element_size()])
        if not bool((bits == bits[0]).all()):
            raise NotTapeable("a table of values that are not all one (a lane-keyed read)")
        lanes = self._lanes(t)
        host = not lanes and t.device.type == "cpu" and self.device.type != "cpu"
        n = self._add(Node("const", (), t.dtype, lanes, value=flat[0].item(), host=host))
        self._bind(t, n)
        return n

    def _emit(self, op, args, out, compute=None) -> None:
        if not isinstance(out, torch.Tensor) or out.device != self.device:
            raise NotTapeable(f"{op} gave a value off the rays' device")
        self._bind(out, self._add(Node(op, tuple(args), out.dtype, self._lanes(out),
                                       compute=compute)))

    def _record(self, name, func, args, kwargs, out) -> None:
        if name in _META:
            if isinstance(out, torch.Tensor):
                raise NotTapeable(f"{name} gave a tensor")
            return
        op = _OPS.get(name)
        if op is None:
            raise NotTapeable(f"{name} is not an elementwise operation of the tape")
        if kwargs.get("out") is not None:
            raise NotTapeable(f"{name} with out=")
        handler = getattr(self, f"_op_{op}", None)
        if handler is not None:
            handler(name, func, args, kwargs, out)
        else:
            self._simple(op, name, args, kwargs, out)

    def _simple(self, op, name, args, kwargs, out) -> None:
        """The operations of one or two operands and no options."""
        arity = 1 if op in _UNARY or op in ("isnan", "not") else 2
        options = {k for k, v in kwargs.items()
                   if not (k == "alpha" and v == 1 or k == "rounding_mode" and v is None)}
        if options or len(args) != arity:
            raise NotTapeable(f"{name} of {len(args)} operands with {sorted(kwargs)}")
        floats = op in _ARITH or op in _UNARY or op in ("rsub", "rdiv")
        if floats != (out.dtype in FLOATS) and op not in _COMPARES and op != "isnan":
            raise NotTapeable(f"{name} on {out.dtype}")
        ops = tuple(self.operand(v) for v in args)
        if op == "rsub":
            self._emit("sub", ops[::-1], out)
        elif op == "rdiv":  # number / tensor: torch takes the reciprocal, then the product
            a = ops[0]
            if self.nodes[a].dtype != out.dtype:
                raise NotTapeable(f"{name} with a cast")
            r = self._add(Node("reciprocal", (a,), out.dtype, self.nodes[a].lanes))
            self._emit("mul", (r, ops[1]), out)
        elif op in _COMPARES:
            compute = torch.result_type(*args)
            if compute not in CTYPES:
                raise NotTapeable(f"{name} in {compute}")
            self._emit(op, ops, out, compute)
        else:
            self._emit(op, ops, out)

    def _op_where(self, name, func, args, kwargs, out) -> None:
        if kwargs:
            raise NotTapeable(f"{name} with {sorted(kwargs)}")
        method = getattr(func, "__qualname__", "").startswith(("TensorBase.", "Tensor."))
        if len(args) != 3:
            raise NotTapeable(f"{name} of {len(args)} arguments")
        x, c, y = args if method else (args[1], args[0], args[2])
        if not isinstance(c, torch.Tensor) or c.dtype != torch.bool:
            raise NotTapeable(f"{name} on a condition that is not bool")
        self._emit("where", tuple(self.operand(v) for v in (c, x, y)), out)

    def _op_clamp(self, name, func, args, kwargs, out) -> None:
        lo, hi = (args[1:] + (None, None))[:2]
        lo, hi = kwargs.get("min", lo), kwargs.get("max", hi)
        if len(args) > 3 or set(kwargs) - {"min", "max"}:
            raise NotTapeable(f"{name} with {sorted(kwargs)}")
        bounds = []
        for v in (lo, hi):
            n = None if v is None else _number(v)
            if v is not None and (n is None or isinstance(n, float) and math.isnan(n)):
                raise NotTapeable(f"{name} with a bound that is no number")
            bounds.append(None if n is None else Scalar(n))
        self._emit("clamp", (self.operand(args[0]), *bounds), out)

    def _op_cast(self, name, func, args, kwargs, out) -> None:
        if not isinstance(out, torch.Tensor):
            raise NotTapeable(f"{name} gave {type(out).__name__}")
        if out is args[0]:
            return
        self._emit("cast", (self.operand(args[0]),), out)

    def _op_alias(self, name, func, args, kwargs, out) -> None:
        if name == "broadcast_tensors":
            pairs = list(zip(args, out))
        else:
            pairs = [(args[0], out)]
        for a, o in pairs:
            if o is a:
                continue
            if not isinstance(o, torch.Tensor) or o.dtype != a.dtype:
                raise NotTapeable(f"{name} gave another dtype")
            self._emit("alias", (self.operand(a),), o)

    def _op_fill(self, name, func, args, kwargs, out) -> None:
        if name in ("tensor", "as_tensor") and args and isinstance(args[0], torch.Tensor):
            if out is args[0]:
                return
            if out.device != args[0].device:
                raise NotTapeable(f"{name} to another device")
            self._emit("cast" if out.dtype != args[0].dtype else "alias",
                       (self.operand(args[0]),), out)
            return
        self._const(out)


def _prune(nodes, out) -> Tape:
    """The nodes *out* reads, in order, renumbered (the inputs kept)."""
    keep = {0, 1, 2}
    for i in range(out, -1, -1):
        if i == out or i in keep:
            keep.add(i)
            keep.update(a for a in nodes[i].args if isinstance(a, int))
    order = sorted(keep)
    new = {old: i for i, old in enumerate(order)}
    fresh = [dataclasses.replace(nodes[i], args=tuple(
        new[a] if isinstance(a, int) else a for a in nodes[i].args)) for i in order]
    return Tape(tuple(fresh), new[out])


def _probe_rays(device):
    """The rays a recording evaluates on: seeded unit-ish rays and the odd
    ones (zeros, signed zeros, NaN, infinities), float32 ``[PROBE_RAYS]``
    each, on *device*."""
    g = torch.Generator().manual_seed(14)
    rays = torch.randn((3, PROBE_RAYS), generator=g, dtype=torch.float32)
    rays[:, :6] = torch.tensor([[0.0, -0.0, math.nan, math.inf, -math.inf, 1.0]] * 3)
    return tuple(r.contiguous().to(device) for r in rays)


def plates_fn(globe):
    """The function a tape records: the resolver's int8 plates of the rays,
    as ``script_pose_plates`` writes them."""
    return lambda x, y, z: script_plates(globe, x, y, z).clamp(-1, MAX_PLATES).to(torch.int8)


def record(fn, device) -> Tape:
    """The :class:`Tape` of ``fn(x, y, z)`` on float32 rays on *device*
    (the device the kernel runs on: whether a constant lies on the host
    shapes how a card divides by it), checked by its own :func:`replay`.
    Raises :class:`NotTapeable` for an operation the tape cannot hold and
    for the evaluator's own refusals (``Unvectorizable``, ``LuaError``);
    any other exception of the evaluation reaches the caller."""
    rays = _probe_rays(device)
    rec = _Recorder(rays)
    try:
        with rec:
            out = fn(*rays)
    except (Unvectorizable, LuaError) as e:  # the evaluator's own refusals
        raise NotTapeable(f"the evaluation raised {type(e).__name__}: {e}") from e
    if rec.refused is not None:
        raise NotTapeable(rec.refused)
    if not isinstance(out, torch.Tensor) or out.dtype != torch.int8 or id(out) not in rec.ids:
        raise NotTapeable("the result is not an int8 tensor of the evaluation")
    tape = _prune(rec.nodes, rec.ids[id(out)])
    if not torch.equal(replay(tape, *rays), out.expand(rays[0].shape)):
        raise NotTapeable("the tape's replay differs from the evaluation")
    return tape


_tapes = weakref.WeakKeyDictionary()  # globe -> {device: its Tape or None}


def tape_of(globe, device):
    """A script globe's :class:`Tape` for K14 on *device*, with its library
    built on a card, or None where the resolver is not tapeable (the
    evaluator runs it).  Recorded at a globe and device's first call, in
    the span ``build.script_tape``, and kept while the globe lives (a
    globe is frozen); the recordings counted by ``tape_of.tapes`` and
    ``tape_of.refusals``, the last refusal's reason in ``tape_of.reason``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    known = _tapes.setdefault(globe, {})
    if device in known:
        return known[device]
    with span("build.script_tape"):
        try:
            tape = record(plates_fn(globe), device)
        except NotTapeable as e:
            tape = None
            tape_of.refusals += 1
            tape_of.reason = str(e)
        if tape is not None and device.type == "cuda":
            library_for(tape)
    tape_of.tapes += tape is not None
    known[device] = tape
    return tape


tape_of.tapes = 0
tape_of.refusals = 0
tape_of.reason = None


# ---------------------------------------------------------------- replay

def _replay_op(n, a, rays, shape):
    op = n.op
    if op == "input":
        return rays[n.value]
    if op == "const":
        dev = "cpu" if n.host else rays[0].device
        return torch.full(shape if n.lanes else (), n.value, dtype=n.dtype, device=dev)
    if op in ("add", "sub", "mul", "div"):
        return {"add": lambda: a[0] + a[1], "sub": lambda: a[0] - a[1],
                "mul": lambda: a[0] * a[1], "div": lambda: a[0] / a[1]}[op]()
    if op in _UNARY or op == "isnan":
        return getattr(torch, op)(a[0])
    if op in _COMPARES:
        return {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
                "eq": torch.eq, "ne": torch.ne}[op](a[0], a[1])
    if op in _BITWISE:
        return {"and": lambda: a[0] & a[1], "or": lambda: a[0] | a[1],
                "xor": lambda: a[0] ^ a[1]}[op]()
    if op == "not":
        return ~a[0]
    if op == "where":
        return torch.where(*a)
    if op == "clamp":
        return torch.clamp(a[0], a[1], a[2])
    if op == "cast":
        return a[0].to(n.dtype)
    if op == "alias":
        return torch.broadcast_to(a[0], shape) if n.lanes and a[0].dim() == 0 else a[0]
    raise ValueError(f"no replay for {op}")


def replay(tape, x, y, z):
    """The tape's operations issued again with torch on the rays ``x, y,
    z`` (float32 tensors of one shape): K14's plain version, the int8
    plates of their shape."""
    shape = tuple(x.shape)
    vals = []
    for n in tape.nodes:
        args = [None if a is None else vals[a] if isinstance(a, int) else a.value
                for a in n.args]
        vals.append(_replay_op(n, args, (x, y, z), shape))
    return torch.broadcast_to(vals[tape.out], shape).contiguous()


# --------------------------------------------------------------- codegen

def literal(value, dtype) -> str:
    """*value* as a C++ literal of *dtype*, the bits torch would hold: a
    float by its bit pattern, after the same rounding."""
    if dtype == torch.float32:
        return f"__int_as_float(0x{int(np.float32(value).view(np.uint32)):08x})"
    if dtype == torch.float64:
        return f"__longlong_as_double(0x{int(np.float64(value).view(np.uint64)):016x}ULL)"
    if dtype == torch.bool:
        return "true" if bool(value) else "false"
    return f"(({CTYPES[dtype]}){int(value)}LL)"


def _reciprocal(value, dtype):
    """``1 / value`` as torch's card computes a host divisor's reciprocal:
    in the operation's float type, rounded once."""
    t = np.float32 if dtype == torch.float32 else np.float64
    with np.errstate(divide="ignore"):
        return t(1) / t(value)


def plate_function(tape) -> str:
    """The tape as a device function ``tape_plate(x, y, z)`` -> the int8
    plate, one statement a node."""
    nodes = tape.nodes
    lines = []

    def arg(a, dtype):
        if isinstance(a, Scalar):
            return literal(a.value, dtype)
        if nodes[a].dtype == dtype:
            return f"v{a}"
        return f"static_cast<{CTYPES[dtype]}>(v{a})"

    def host_value(a):
        if isinstance(a, Scalar):
            return a.value
        return nodes[a].value if nodes[a].op == "const" and nodes[a].host else None

    for i, n in enumerate(nodes):
        T, op = n.dtype, n.op
        f = "f" if T == torch.float32 else "d"
        if op == "input":
            e = "xyz"[n.value]
        elif op == "const":
            e = literal(n.value, T)
        elif op == "div" and host_value(n.args[1]) is not None:
            e = f"__{f}mul_rn({arg(n.args[0], T)}, " \
                f"{literal(_reciprocal(host_value(n.args[1]), T), T)})"
        elif op in _ARITH:
            e = f"__{f}{op}_rn({arg(n.args[0], T)}, {arg(n.args[1], T)})"
        elif op == "reciprocal":
            e = f"__{f}div_rn({literal(1, T)}, {arg(n.args[0], T)})"
        elif op == "neg":
            e = f"(-{arg(n.args[0], T)})"
        elif op in ("abs", "trunc", "floor", "ceil"):
            e = f"{'fabs' if op == 'abs' else op}{'f' if T == torch.float32 else ''}(" \
                f"{arg(n.args[0], T)})"
        elif op == "isnan":
            a = n.args[0]
            e = f"(v{a} != v{a})" if nodes[a].dtype in FLOATS else "false"
        elif op in _COMPARES:
            e = f"({arg(n.args[0], n.compute)} {_COMPARES[op]} {arg(n.args[1], n.compute)})"
        elif op in _BITWISE:
            e = f"static_cast<{CTYPES[T]}>({arg(n.args[0], T)} {_BITWISE[op]} " \
                f"{arg(n.args[1], T)})"
        elif op == "not":
            e = f"(!{arg(n.args[0], T)})" if T == torch.bool else \
                f"static_cast<{CTYPES[T]}>(~{arg(n.args[0], T)})"
        elif op == "where":
            c, a, b = n.args
            e = f"({arg(c, torch.bool)} ? {arg(a, T)} : {arg(b, T)})"
        elif op == "clamp":
            # torch's: NaN stays, else min(max(v, lo), hi)
            v, lo, hi = n.args
            e = arg(v, T)
            mx, mn = ("fmaxf", "fminf") if T == torch.float32 else (
                ("fmax", "fmin") if T == torch.float64 else ("max", "min"))
            if lo is not None:
                e = f"{mx}({e}, {arg(lo, T)})"
            if hi is not None:
                e = f"{mn}({e}, {arg(hi, T)})"
            if T in FLOATS:
                e = f"(v{v} != v{v} ? {arg(v, T)} : {e})" if nodes[v].dtype == T else \
                    f"({arg(v, T)} != {arg(v, T)} ? {arg(v, T)} : {e})"
        elif op in ("cast", "alias"):
            e = arg(n.args[0], T)
        else:
            raise ValueError(f"no code for {op}")
        lines.append(f"  const {CTYPES[T]} v{i} = {e};")
    return ("__device__ __forceinline__ signed char tape_plate(const float x, const float y, "
            "const float z) {\n" + "\n".join(lines)
            + f"\n  return static_cast<signed char>(v{tape.out});\n}}\n")


_KERNEL = r"""
// One thread a run of four rays of K13's planes: three streaming float4
// loads, the four plates stored as one word; a run off 16 bytes, or a
// short last one, a ray at a time.
__global__ void __launch_bounds__(256) script_tape_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ z,
    long long n, signed char* __restrict__ out, bool vec) {
  const long long p = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (p >= n) return;
  if (vec && p + 4 <= n) {
    const float4 a = __ldcs((const float4*)(x + p)), b = __ldcs((const float4*)(y + p)),
                 c = __ldcs((const float4*)(z + p));
    const unsigned w = (unsigned)(unsigned char)tape_plate(a.x, b.x, c.x) |
                       (unsigned)(unsigned char)tape_plate(a.y, b.y, c.y) << 8 |
                       (unsigned)(unsigned char)tape_plate(a.z, b.z, c.z) << 16 |
                       (unsigned)(unsigned char)tape_plate(a.w, b.w, c.w) << 24;
    __stcs((unsigned*)(out + p), w);
    return;
  }
  for (int i = 0; i < 4 && p + i < n; ++i)
    out[p + i] = tape_plate(__ldcs(x + p + i), __ldcs(y + p + i), __ldcs(z + p + i));
}

}  // namespace

// x, y, z [n] f32 and out [n] int8 on the device; launches on `stream` and
// returns cudaGetLastError() after the launch.
extern "C" int blinky_script_tape(const float* x, const float* y, const float* z, long long n,
                                  signed char* out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const bool vec = ((uintptr_t)x | (uintptr_t)y | (uintptr_t)z) % 16 == 0 &&
                   (uintptr_t)out % 4 == 0;
  const long long blocks = (n + 4LL * 256 - 1) / (4LL * 256);
  script_tape_kernel<<<(unsigned)blocks, 256, 0, stream>>>(x, y, z, n, out, vec);
  return (int)cudaGetLastError();
}
"""


def cuda_source(tape) -> str:
    """K14's CUDA C++ for *tape*: :func:`plate_function` and the kernel
    that runs it over the rays, with the entry point
    ``blinky_script_tape``."""
    return ("// K14, generated by blinky_tpu_torch/kernels/script_tape.py from a script\n"
            "// globe's tape: its plate resolver as one pass over the rays.\n"
            "#include <stdint.h>\n#include <cuda_runtime.h>\n\nnamespace {\n\n"
            + plate_function(tape) + _KERNEL)


# ----------------------------------------------------------- the library

_lock = threading.Lock()
_libs = {}  # digest -> the bound library


def library_for(tape):
    """The tape's library, built into ``build/`` if missing (named by the
    hash of its source) and bound on first use in the process; builds
    counted by ``library_for.builds``, nvcc's output of the last in
    ``library_for.log``."""
    with _lock:
        lib = _libs.get(tape.digest)
        if lib is not None:
            return lib
        cu = _build.BUILD_DIR / f"script_tape_{tape.digest}.cu"
        so = _build.BUILD_DIR / f"libblinky_script_tape_{tape.digest}.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if not cu.exists() or cu.read_text() != tape.source:
            tmp = cu.with_name(f"{cu.name}.{os.getpid()}.tmp")
            tmp.write_text(tape.source)
            os.replace(tmp, cu)
        proc = _build.compile_locked(so, [cu], lambda out: [
            _build._nvcc(), *_build.NVCC_FLAGS, *NVCC_FLAGS, "-o", str(out), str(cu)])
        if proc is not None:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {cu}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            library_for.builds += 1
            library_for.log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(so))
        vp = ctypes.c_void_p
        lib.blinky_script_tape.argtypes = [vp, vp, vp, ctypes.c_longlong, vp, vp]
        lib.blinky_script_tape.restype = ctypes.c_int
        _libs[tape.digest] = lib
        return lib


library_for.builds = 0
library_for.log = None


# ---------------------------------------------------------------- launch

def script_tape(tape, x, y, z, out):
    """K14: *tape*'s int8 plates of the rays ``x, y, z`` (contiguous
    float32 tensors of one shape, K13's planes) written into *out*, a
    contiguous int8 tensor of their shape on their device.  Launches
    ``blinky_script_tape`` for tensors on a card and writes
    :func:`replay`'s plates for tensors on the CPU."""
    name = "script_tape"
    dev, shape = x.device, tuple(x.shape)
    for what, t, dtype in (("x", x, torch.float32), ("y", y, torch.float32),
                           ("z", z, torch.float32), ("out", out, torch.int8)):
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name}: {what} must be a contiguous {dtype} tensor of shape "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not _build.on_card(name, dev):
        out.copy_(replay(tape, x, y, z))
        return out
    lib = library_for(tape)
    with _build.on_device(dev) as stream:
        if out.numel():
            _build.launch(script_tape, name, "blinky_script_tape", x.data_ptr(), y.data_ptr(),
                          z.data_ptr(), out.numel(), out.data_ptr(), stream, lib=lib)
    return out


script_tape.launches = 0
