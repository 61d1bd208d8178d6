"""The port's vectorized Lua evaluator against its scalar interpreter, the
JAX package's evaluator, and its own tensor mode.

* The NumPy vector path (``blinky_tpu_torch.lua_vector.VectorInterpreter``
  on arrays) must be bit-equal lane for lane to the port's scalar
  interpreter and to ``blinky_tpu.lua_vector.VectorInterpreter``, or both
  vector paths raise ``Unvectorizable``.  The programs: the random-program
  generator of ``tests/test_lua_vector_fuzz.py`` (ported below, 100 seeds,
  inputs from numpy) and the 16 files of ``tests/lua_fuzz_corpus/``.  A
  program the scalar interpreter refuses must be refused by the JAX
  package's scalar interpreter with the same error.
* The tensor mode (the same evaluator on CPU float64 tensors) must decide
  like the JAX package's traced mode (run eagerly on jax arrays): it
  evaluates exactly the programs that one evaluates.  The two modes never
  inspect a lane, while the NumPy path does (it skips an arm no lane takes,
  and refuses a lane it sees touch nil), so their decisions differ from the
  NumPy path's by design; where the NumPy path evaluates too, the tensor
  mode gives the same nil masks and values bit-equal where a program uses
  only ``+ - * / % ^``, comparisons, ``floor`` and ``abs``, else within
  ``rtol 1e-12`` on finite lanes (torch's float64 transcendentals are not
  glibc's).
* A float32 evaluation stays float32, and the tensor mode's masked loop,
  which stops once no lane is alive, gives the values of the full
  ``TRACE_LOOP_CAP`` unroll bit for bit.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from blinky_tpu.lua_vector import Unvectorizable as JUnvectorizable
from blinky_tpu.lua_vector import VectorInterpreter as JVector
from blinky_tpu.minilua import Interpreter as JScalar
from blinky_tpu.minilua import LuaError as JLuaError
from blinky_tpu_torch.lua_vector import Unvectorizable, VectorInterpreter
from blinky_tpu_torch.minilua import Interpreter, LuaError

FUZZ_SEEDS = int(os.environ.get("BLINKY_LUA_FUZZ_SEEDS", "100"))
CORPUS = sorted((Path(__file__).parent / "lua_fuzz_corpus").glob("*.lua"))
# math functions whose float64 results torch computes without glibc
TRANSCENDENTAL = ("sin", "cos", "tan", "exp", "log", "atan", "tanh", "sqrt", "pow")


class _Gen:
    """A tiny random-program generator over the numeric mini-Lua subset
    the lens scripts use: arithmetic, math builtins, comparisons,
    if/elseif chains with returns (incl. nil), bounded loops with
    data-dependent breaks, helper calls, partial assignment + nil
    checks."""

    UNARY = ["math.sin", "math.cos", "math.sqrt", "math.abs", "math.exp",
             "math.atan", "math.floor", "math.tanh"]
    BINARY = ["+", "-", "*", "/", "%", "^"]
    CMP = ["<", ">", "<=", ">=", "==", "~="]

    def __init__(self, rng):
        self.r = rng

    def const(self):
        return f"{self.r.uniform(-3, 3):.4f}"

    def expr(self, vars_, depth=0):
        roll = self.r.random()
        if depth > 2 or roll < 0.25:
            return self.r.choice(vars_) if self.r.random() < 0.7 else self.const()
        if roll < 0.5:
            return (f"{self.r.choice(self.UNARY)}"
                    f"({self.expr(vars_, depth + 1)})")
        if roll < 0.6:
            return (f"math.{self.r.choice(['max', 'min'])}"
                    f"({self.expr(vars_, depth + 1)}, {self.expr(vars_, depth + 1)})")
        op = self.r.choice(self.BINARY)
        return f"({self.expr(vars_, depth + 1)} {op} {self.expr(vars_, depth + 1)})"

    def cond(self, vars_):
        c = (f"{self.expr(vars_)} {self.r.choice(self.CMP)} "
             f"{self.expr(vars_)}")
        if self.r.random() < 0.3:
            c2 = (f"{self.expr(vars_)} {self.r.choice(self.CMP)} "
                  f"{self.expr(vars_)}")
            c = f"({c}) {self.r.choice(['and', 'or'])} ({c2})"
        return c

    def block(self, vars_, indent, depth, allow_return=True):
        lines = []
        n = self.r.integers(1, 4)
        local_vars = list(vars_)
        for _ in range(n):
            roll = self.r.random()
            pad = "  " * indent
            if roll < 0.35:
                name = f"v{self.r.integers(0, 6)}"
                lines.append(f"{pad}local {name} = {self.expr(local_vars)}")
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.55 and depth < 2:
                arms = [f"{pad}if {self.cond(local_vars)} then"]
                arms.append(self.block(local_vars, indent + 1, depth + 1))
                if self.r.random() < 0.5:
                    arms.append(f"{pad}elseif {self.cond(local_vars)} then")
                    arms.append(self.block(local_vars, indent + 1, depth + 1))
                if self.r.random() < 0.6:
                    arms.append(f"{pad}else")
                    arms.append(self.block(local_vars, indent + 1, depth + 1))
                arms.append(f"{pad}end")
                lines.append("\n".join(arms))
            elif roll < 0.66 and depth < 2:
                # bounded loop, optionally with a data-dependent break;
                # round 3: sometimes a generic for over a literal table
                # (ipairs iterator protocol + masked body/breaks); late
                # round 3: sometimes the goto-continue idiom (the vector
                # path must refuse goto cleanly — scalar authority)
                name = f"v{self.r.integers(0, 6)}"
                if self.r.random() < 0.2:
                    body = [f"{pad}local {name} = {self.expr(local_vars)}",
                            f"{pad}for i{depth} = 1, {self.r.integers(2, 5)} do",
                            f"{pad}  if {self.cond(local_vars)} then "
                            f"goto cont{depth} end",
                            f"{pad}  {name} = {name} * 0.5 + "
                            f"{self.expr(local_vars, 2)}",
                            f"{pad}  ::cont{depth}::",
                            f"{pad}end"]
                    lines.append("\n".join(body))
                    if name not in local_vars:
                        local_vars.append(name)
                    continue
                if self.r.random() < 0.3:
                    consts = ", ".join(self.const()
                                       for _ in range(self.r.integers(2, 5)))
                    body = [f"{pad}local {name} = {self.expr(local_vars)}",
                            f"{pad}for gi{depth}, gw{depth} in "
                            f"ipairs({{{consts}}}) do",
                            f"{pad}  {name} = {name} * 0.5 + gw{depth} + "
                            f"{self.expr(local_vars, 2)}"]
                    if self.r.random() < 0.5:
                        body.append(
                            f"{pad}  if {self.cond([name])} then break end")
                    body.append(f"{pad}end")
                else:
                    body = [f"{pad}local {name} = {self.expr(local_vars)}",
                            f"{pad}for i{depth} = 1, {self.r.integers(2, 5)} do",
                            f"{pad}  {name} = {name} * 0.5 + "
                            f"{self.expr(local_vars, 2)}"]
                    if self.r.random() < 0.5:
                        body.append(
                            f"{pad}  if {self.cond([name])} then break end")
                    body.append(f"{pad}end")
                lines.append("\n".join(body))
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.72 and depth < 2:
                # late round 3: metatable class arithmetic — uniform
                # metatables must vectorize bit-equal through the base
                # machinery (constructors inside masked branches use the
                # fresh-install allowance); per-lane dispatch must
                # refuse cleanly
                name = f"v{self.r.integers(0, 6)}"
                # half the time: table OP lane-array (the __mul handler
                # dispatches through the vector call machinery)
                tail = (f"(q{depth} * {self.expr(local_vars, 2)}).a"
                        if self.r.random() < 0.5 else
                        f"q{depth}.a * 0.5 + (-q{depth}).b")
                lines.append(
                    f"{pad}local p{depth} = V.new({self.expr(local_vars)}, "
                    f"{self.expr(local_vars, 2)})\n"
                    f"{pad}local q{depth} = p{depth} + "
                    f"V.new({self.const()}, {self.const()})\n"
                    f"{pad}local {name} = {tail}")
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.76:
                # late round 3: string library work — uniform args run
                # identically on both engines; a lane-varying arg must
                # hit the Unvectorizable wrapper (never a script error
                # the scalar path wouldn't raise)
                name = f"v{self.r.integers(0, 6)}"
                arg = (self.expr(local_vars, 2)
                       if self.r.random() < 0.3 else self.const())
                lines.append(
                    f'{pad}local s{depth} = string.format("%.2f", {arg})\n'
                    f'{pad}local _, n{depth} = string.gsub(s{depth}, '
                    f'"%d", "#")\n'
                    f"{pad}local {name} = n{depth} + #s{depth} + "
                    f"{self.expr(local_vars, 2)}")
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.79:
                # round 5: a load()'d chunk is an ordinary function and
                # must vectorize bit-equal (args ride `...` — a chunk
                # cannot see the caller's locals)
                name = f"v{self.r.integers(0, 6)}"
                lines.append(
                    f'{pad}local cf{depth} = load('
                    f'"local a, b = ... ; return a * 0.5 + b")\n'
                    f"{pad}local {name} = cf{depth}("
                    f"{self.expr(local_vars, 2)}, "
                    f"{self.expr(local_vars, 2)})")
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.815:
                # round 5: coroutines are scalar authority — the vector
                # engine must refuse cleanly (never diverge, never raise
                # an error the scalar path wouldn't).  The coroutine
                # FINISHES (second call reaches the return) so scalar
                # replay never parks threads against the live cap.
                name = f"v{self.r.integers(0, 6)}"
                lines.append(
                    f"{pad}local co{depth} = coroutine.wrap(function(a)\n"
                    f"{pad}  coroutine.yield(a * 0.5)\n"
                    f"{pad}  return a + 1\n"
                    f"{pad}end)\n"
                    f"{pad}local {name} = co{depth}("
                    f"{self.expr(local_vars, 2)}) + co{depth}()")
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.84:
                # lane-varying DENSE-table read (round 3: vectorizes when
                # every active key is an integer in range; the % keeps it
                # in 1..3 most of the time, and the occasional wider
                # modulus produces out-of-range keys the vector path must
                # cleanly refuse)
                name = f"v{self.r.integers(0, 6)}"
                mod = 3 if self.r.random() < 0.8 else 5
                lines.append(
                    f"{pad}local {name} = LUT[math.floor(math.abs("
                    f"{self.expr(local_vars, 2)}) * 2) % {mod} + 1]\n"
                    f"{pad}if {name} == nil then {name} = 0.5 end")
                if name not in local_vars:
                    local_vars.append(name)
            elif roll < 0.94 and allow_return:
                if self.r.random() < 0.25:
                    # all-nil returns mark the lanes nil for every slot
                    # (round 3: `return nil, nil` too, like debug.lua)
                    lines.append(f"{pad}return nil"
                                 + (", nil" if self.r.random() < 0.4 else ""))
                else:
                    lines.append(f"{pad}return {self.expr(local_vars)}, "
                                 f"{self.expr(local_vars)}")
                break  # statements after return don't parse in a block
            else:
                # partial assignment + nil check (the _MaybeNil machinery)
                name = f"g{self.r.integers(0, 3)}"
                lines.append(
                    f"{pad}local {name}\n"
                    f"{pad}if {self.cond(local_vars)} then {name} = "
                    f"{self.expr(local_vars)} end\n"
                    f"{pad}if {name} == nil then {name} = {self.const()} end")
                if name not in local_vars:
                    local_vars.append(name)
        return "\n".join(lines)

    def program(self):
        # a dense numeric table for the lane-varying-read branch
        lut = ("LUT = {" + ", ".join(self.const() for _ in range(3))
               + "}\n")
        # a metatable class for the class-arithmetic branch (late r3)
        lut += ("V = {}\nV.__index = V\n"
                "function V.new(a, b) "
                "return setmetatable({a = a, b = b}, V) end\n"
                "V.__add = function(u, w) "
                "return V.new(u.a + w.a, u.b + w.b) end\n"
                "V.__mul = function(u, s) "
                "return V.new(u.a * s, u.b * s) end\n"
                "V.__unm = function(u) return V.new(-u.a, -u.b) end\n")
        if self.r.random() < 0.25:
            # round 3: a varargs helper (select + `...` destructuring)
            helper = ("function h(...)\n"
                      "  local n = select(\"#\", ...)\n"
                      "  local a, b = ...\n"
                      f"{self.block(['a', 'b'], 1, 1, allow_return=False)}\n"
                      "  return (a + b) * 0.5 + n\nend\n")
        else:
            helper = (f"function h(a, b)\n"
                      f"{self.block(['a', 'b'], 1, 1, allow_return=False)}\n"
                      f"  return (a + b) * 0.5\nend\n")
        use_helper = self.r.random() < 0.5
        vars_ = ["x", "y"]
        # a guarded top-level nil return (inside an if: the body's own
        # trailing return must stay the block's last statement)
        guard = (f"  if {self.cond(vars_)} then return nil end\n"
                 if self.r.random() < 0.6 else "")
        body = self.block(vars_, 1, 0, allow_return=False)
        call = "  local hh = h(x, y)\n" if use_helper else ""
        tail_vars = vars_ + (["hh"] if use_helper else [])
        return (lut + helper +
                f"function f(x, y)\n{call}{guard}{body}\n"
                f"  return {self.expr(tail_vars)}, {self.expr(tail_vars)}\nend\n")


def _generated(seed):
    rng = np.random.default_rng(1000 + seed)
    src = _Gen(rng).program()
    return src, rng.uniform(-2.5, 2.5, 48), rng.uniform(-2.5, 2.5, 48)


def _corpus(path):
    rng = np.random.default_rng(int.from_bytes(path.stem.encode()[:4], "big"))
    n = 96  # denser lanes than the generator: corner cases need hits
    x = np.concatenate([rng.uniform(-2.5, 2.5, n - 2), [0.0, 1.0]])
    y = np.concatenate([rng.uniform(-2.5, 2.5, n - 2), [0.0, -1.0]])
    return path.read_text(), x, y


CASES = ([pytest.param(*_generated(s), id=f"seed{s}") for s in range(FUZZ_SEEDS)]
         + [pytest.param(*_corpus(p), id=p.stem) for p in CORPUS])


def _vector(cls, refusal, src, x, y, error=()):
    """(values as [n] float64 arrays or None, nil mask [n]), "refused", or
    "error" for one of *error*."""
    it = cls()
    try:
        it.run(src)
        with np.errstate(all="ignore"):
            vals, nil = it.vcall(it.get_global("f"), [x, y])
    except refusal:
        return "refused"
    except error:
        return "error"
    n = len(x)

    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.cpu().numpy()
        return np.asarray(v)

    if len(vals) == 0:  # every lane nil
        return [], np.ones(n, bool)
    out = [None if v is None else np.broadcast_to(host(v).astype(np.float64), (n,))
           for v in vals]
    nil = np.zeros(n, bool) if nil is None else np.broadcast_to(host(nil), (n,))
    return out, nil


def _scalar(cls, error, src, x, y):
    """Per-lane results of the scalar interpreter, or its error."""
    it = cls()
    try:
        it.run(src)
        f = it.get_global("f")
        return [it.call(f, [float(a), float(b)]) for a, b in zip(x, y)]
    except error as e:
        return ("error", str(e))
    finally:
        it.close()


def _same_value(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("src,x,y", CASES)
def test_numpy_path_bitequal_scalar_and_jax(src, x, y):
    truth = _scalar(Interpreter, LuaError, src, x, y)
    if isinstance(truth, tuple):
        # the scalar interpreter refuses the program: so does the JAX one
        assert truth == _scalar(JScalar, JLuaError, src, x, y)
        return
    got = _vector(VectorInterpreter, Unvectorizable, src, x, y)
    want = _vector(JVector, JUnvectorizable, src, x, y)
    if got == "refused" or want == "refused":
        assert got == want
        return
    assert np.array_equal(got[1], want[1])
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        assert (g is None) == (w is None)
        if g is not None:
            assert np.array_equal(g, w, equal_nan=True)
    vals, nil = got
    for i, lane in enumerate(truth):
        if nil[i]:
            assert len(lane) == 0 or all(v is None for v in lane), (i, lane)
            continue
        assert len(lane) == len(vals), (i, lane)
        for j, s in enumerate(lane):
            if s is None:
                assert vals[j] is None
            else:
                assert _same_value(float(s), float(vals[j][i])), (i, j, s, vals[j][i])


def _decision(v):
    return v if isinstance(v, str) else "evaluated"


@pytest.mark.parametrize("src,x,y", CASES)
def test_tensor_mode_decides_like_jax_and_agrees_with_numpy(src, x, y):
    import jax.numpy as jnp

    got = _vector(VectorInterpreter, Unvectorizable, src, torch.from_numpy(x),
                  torch.from_numpy(y), (LuaError, TypeError))
    traced = _vector(JVector, JUnvectorizable, src, jnp.asarray(x), jnp.asarray(y),
                     (JLuaError, TypeError))
    assert _decision(got) == _decision(traced)
    ref = _vector(VectorInterpreter, Unvectorizable, src, x, y, (LuaError, TypeError))
    if isinstance(got, str) or isinstance(ref, str):
        return
    assert np.array_equal(got[1], ref[1])
    live = ~ref[1]
    if not live.any():
        return
    assert len(got[0]) == len(ref[0])
    exact = not any(f"{name}(" in src for name in TRANSCENDENTAL)
    for g, r in zip(got[0], ref[0]):
        g, r = g[live], r[live]
        if exact:
            assert np.array_equal(g, r, equal_nan=True)
        else:
            fin = np.isfinite(r)
            assert np.array_equal(np.isfinite(g), fin)
            np.testing.assert_allclose(g[fin], r[fin], rtol=1e-12, atol=0)


FLOAT32_PROGRAM = """
T = {0.25, 0.5, 0.75}
function f(x, y)
  local a = x * 0.1 + 2 - y / 3
  local b = math.max(a, 0.5, y) + math.min(-1, x) + math.abs(y) ^ 2
  local c = T[math.floor(math.abs(x)) % 3 + 1] + math.floor(a) % 2
  local d
  if x > 0 then d = 1 else d = a end
  local n = 0
  repeat
    a = a * 0.5
    n = n + 1
  until a < 0.01 or n > 20
  return a + b + c + d, math.sqrt(math.abs(b)) + math.atan2(x, y) + math.rad(n)
end
"""


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tensor_mode_keeps_the_dtype(dtype):
    """A float32 evaluation stays float32 throughout: every number that
    meets a tensor, a merge of two numbers under a mask, a table read at a
    lane-varying key and the loop's counter take the inputs' dtype."""
    it = VectorInterpreter()
    it.run(FLOAT32_PROGRAM)
    x = torch.linspace(-3, 3, 40, dtype=dtype)
    seen = []
    orig = it._twhere

    def spy(c, a, b):
        out = orig(c, a, b)
        seen.append(out.dtype)
        return out

    it._twhere = spy
    vals, nil = it.vcall(it.get_global("f"), [x, x.flip(0)])
    assert [v.dtype for v in vals] == [dtype, dtype]
    assert seen and all(d in (dtype, torch.bool) for d in seen)


class _FullUnroll(VectorInterpreter):
    """The JAX package's bounded unroll: every loop runs all
    TRACE_LOOP_CAP masked iterations."""

    @staticmethod
    def _any_alive(alive):
        return True


LOOP_PROGRAM = """
function f(x, y)
  local lat = y
  local n = 0
  repeat
    local step = (lat + 0.5 * math.sin(lat) - y) / (1 + 0.5 * math.cos(lat))
    lat = lat - step
    n = n + 1
  until math.abs(step) < 1e-6 or n >= 30
  local k = 0
  while k < x * x do
    k = k + 1
    if k > 5 then break end
  end
  return lat, n + k
end
"""


def test_masked_loop_equals_full_unroll():
    x = torch.linspace(-2.5, 2.5, 64, dtype=torch.float32)
    y = torch.linspace(1.9, -1.9, 64, dtype=torch.float32)
    calls = {"n": 0}

    class Counting(VectorInterpreter):
        @staticmethod
        def _any_alive(alive):
            calls["n"] += 1
            return bool(alive.any())

    runs = []
    for cls in (Counting, _FullUnroll):
        it = cls()
        it.run(LOOP_PROGRAM)
        runs.append(it.vcall(it.get_global("f"), [x, y])[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the early stop ran far fewer than the cap's iterations
    assert 2 < calls["n"] < 2 * VectorInterpreter.TRACE_LOOP_CAP // 3
    # and the values are those of the NumPy path on the same float32 lanes
    it = VectorInterpreter()
    it.run(LOOP_PROGRAM)
    want = it.vcall(it.get_global("f"), [x.double().numpy(), y.double().numpy()])[0]
    np.testing.assert_allclose(runs[0][0].double().numpy(), want[0], atol=2e-6)
    assert np.array_equal(runs[0][1].double().numpy(), want[1])
