"""K14's tape on the CPU: a script globe's resolver recorded once as
elementwise operations (``kernels/script_tape.py``), replayed with torch,
and written as the CUDA C++ of K14, whose plate function also compiles
for the host.

For each tapeable script (the port's ``lfast.lua`` drop-in, the card
tests' odd resolver and max-dot resolver, a script that divides by
numbers and one that takes a Lua ``%`` and a reciprocal), the tape's
replay equals the evaluator's plates bit for bit on dense rays, on rays on
the plates' edges and on NaN and infinite rays; the plate function, built
with ``g++`` for the host (the CUDA intrinsics as plain IEEE operations,
no contraction), gives the same plates where the script divides by no
host number.  Scripts with a data-dependent loop or a lane-keyed table
read record as not tapeable and keep the evaluator.
"""

import ctypes
import math
import re
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blinky_tpu_torch import globes
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench import lua_drop_ins
from blinky_tpu_torch.kernels import _build, script_tape, static_ray
from blinky_tpu_torch.lensmap.builder import plate_resolver_mode, script_plates
from blinky_tpu_torch.lua_bridge import load_lua_globe

CPU = torch.device("cpu")

# the card tests' resolver of every kind of plate: NaN and nil (-> -1),
# values below 0 and past the last plate; a product summed with a ray
ODD = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90} }
function globe_plate(x, y, z)
  if x > 0.6 then return 0 / 0 end
  if y > 0.55 then return nil end
  return math.floor((x + 1) * 4 + z) - 1
end
"""

# divisions by numbers: a card computes them as products by the float
# reciprocal, the CPU divides
SCALAR_DIV = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90}, {{1, 0, 0}, {0, 1, 0}, 90} }
function globe_plate(x, y, z)
  local r = x / 3 + y / 7
  if r > 0.1 then return 1 end
  return 0
end
"""

# Lua's % (a - floor(a / b) * b) and a number over a ray (a reciprocal)
MOD = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90}, {{1, 0, 0}, {0, 1, 0}, 90}, {{0, 1, 0}, {0, 0, 1}, 90} }
function globe_plate(x, y, z)
  local a = (x * 10) % 3
  local w = 1 / (z + 2)
  if a < 1 and w > 0.4 then return 0 elseif a < 2 then return 1 end
  return 2
end
"""

# a data-dependent repeat loop: each iteration asks whether a lane is alive
REPEAT = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90}, {{0, 0, 1}, {0, 1, 0}, 160} }
function globe_plate(x, y, z)
  local k = 0
  local t = math.abs(x) + 0.2
  repeat
    t = t * 0.5
    k = k + 1
  until t < 0.1
  if k > 2 then return 1 end
  return 0
end
"""

# a table read at a lane-varying key (debug.lua's cols[r + 1])
TABLE = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90}, {{0, 0, 1}, {0, 1, 0}, 160} }
cols = {0, 1, 1, 0}
function globe_plate(x, y, z)
  local r = math.floor(math.abs(x) * 3) % 4
  return cols[r + 1]
end
"""


def _maxdot(globe_name):
    """A resolver that picks the strict first maximum of the globe's
    float32 forward dots, as the max-dot kernels do."""
    g = globes.get(globe_name)
    rows = ", ".join("{" + ", ".join(repr(float(c)) for c in f) + "}" for f in g.forward)
    return f"""
plates = {{ {{{{0, 0, 1}}, {{0, 1, 0}}, 90}} }}
F = {{{rows}}}
function globe_plate(x, y, z)
  local best = x * F[1][1] + y * F[1][2] + z * F[1][3]
  local p = 0
  for k = 2, #F do
    local d = x * F[k][1] + y * F[k][2] + z * F[k][3]
    if d > best then
      best = d
      p = k - 1
    end
  end
  return p
end
"""


# one plate whatever the ray: the evaluator makes the number a float64 tensor
CONSTANT = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90} }
function globe_plate(x, y, z)
  return 0
end
"""

TAPEABLE = {"lfast": lua_drop_ins.LFAST, "odd": ODD, "maxdot": _maxdot("cube"),
            "scalar_div": SCALAR_DIV, "mod": MOD, "constant": CONSTANT}
HOST_DIVISION = {"scalar_div", "mod"}  # a card's division by a number is not the CPU's


def _globe(tmp_path, name, src):
    path = tmp_path / f"{name}.lua"
    path.write_text(src)
    g = load_lua_globe(path)
    assert plate_resolver_mode(g) == "script"
    return g


def _rays(kind):
    """float32 ray planes ``x, y, z`` of one shape."""
    g = torch.Generator().manual_seed(len(kind))
    if kind == "dense":
        return tuple(torch.randn((3, 37, 41), generator=g).unbind(0))
    if kind == "edges":
        # on the plates' edges: |u| = half where x = +-z (lfast's window is
        # 90 degrees), z = 0 and -0, the odd resolver's 0.6 and 0.55
        z = torch.rand(200, generator=g) + 0.1
        t = torch.tensor([1.0, -1.0, np.nextafter(np.float32(1), np.float32(2)),
                          np.nextafter(np.float32(1), np.float32(0))], dtype=torch.float32)
        x = torch.cat([z * t[i % 4] for i in range(4)] + [torch.zeros(8), torch.full((4,), 0.6)])
        y = torch.cat([torch.randn(800, generator=g) * 0.3, torch.zeros(8),
                       torch.full((4,), 0.55)])
        z = torch.cat([z.repeat(4), torch.tensor([0.0, -0.0] * 4), torch.ones(4)])
        y[:200] = z[:200] * t[0]  # both edges at once
        return x, y, z
    odd = torch.tensor([math.nan, math.inf, -math.inf, 0.0, -0.0, 1.0, -1.0, 1e-30])
    grid = torch.cartesian_prod(odd, odd, odd).t()
    return tuple(grid[i].contiguous() for i in range(3))


def _evaluator(globe, x, y, z):
    return script_plates(globe, x, y, z).clamp(-1, 6).to(torch.int8)


@pytest.fixture(scope="module")
def tapes(tmp_path_factory):
    d = tmp_path_factory.mktemp("globes")
    out = {}
    for name, src in TAPEABLE.items():
        g = _globe(d, name, src)
        out[name] = (g, script_tape.record(script_tape.plates_fn(g), CPU))
    return out


def test_lfasts_tape_is_a_handful_of_elementwise_operations(tapes):
    """fast.lua's ``globe_plate`` records as about 30 elementwise operations
    on the three inputs: its two divisions, two products, two absolutes
    and three compares among them."""
    ops = [n.op for n in tapes["lfast"][1].nodes]
    assert ops[:3] == ["input"] * 3
    assert 25 <= len(ops) <= 45
    assert ops.count("div") == 2 and ops.count("mul") == 2 and ops.count("abs") == 2
    assert ops.count("lt") == 2 and ops.count("le") == 1 and ops.count("isnan") == 1
    assert tapes["lfast"][1].nodes[-1].dtype == torch.int8


@pytest.mark.parametrize("kind", ["dense", "edges", "odd"])
@pytest.mark.parametrize("name", list(TAPEABLE))
def test_the_replay_equals_the_evaluator(tapes, name, kind):
    g, tape = tapes[name]
    x, y, z = _rays(kind)
    want = _evaluator(g, x, y, z)
    assert torch.equal(script_tape.replay(tape, x, y, z), want)
    out = torch.empty_like(want)
    assert script_tape.script_tape(tape, x, y, z, out) is out and torch.equal(out, want)
    assert len(set(want.unique().tolist())) > 1 or kind == "odd" or name == "constant"


HOST_SHIM = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
using std::max;
using std::min;
#define __device__
#define __forceinline__ inline
static inline float __int_as_float(unsigned v) { float f; memcpy(&f, &v, 4); return f; }
static inline double __longlong_as_double(unsigned long long v) {
  double d; memcpy(&d, &v, 8); return d; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
static inline double __dadd_rn(double a, double b) { return a + b; }
static inline double __dsub_rn(double a, double b) { return a - b; }
static inline double __dmul_rn(double a, double b) { return a * b; }
static inline double __ddiv_rn(double a, double b) { return a / b; }
"""

HOST_RUN = r"""
extern "C" void run(const float* x, const float* y, const float* z, long long n,
                    signed char* out) {
  for (long long i = 0; i < n; ++i) out[i] = tape_plate(x[i], y[i], z[i]);
}
"""


def _host_plates(tape, tmp_path):
    """The tape's plate function built for the host with g++ (no contraction
    of a product into a sum), as a function of three float32 tensors."""
    src = tmp_path / "tape.cpp"
    lib = tmp_path / "libtape.so"
    src.write_text(HOST_SHIM + script_tape.plate_function(tape) + HOST_RUN)
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(lib), str(src)], check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(lib)).run
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]

    def plates(x, y, z):
        x, y, z = (t.contiguous() for t in (x, y, z))
        out = torch.empty(x.shape, dtype=torch.int8)
        fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), x.numel(), out.data_ptr())
        return out

    return plates


@pytest.mark.parametrize("name", sorted(set(TAPEABLE) - HOST_DIVISION))
def test_the_plate_function_built_for_the_host_equals_the_evaluator(tapes, name, tmp_path):
    g, tape = tapes[name]
    plates = _host_plates(tape, tmp_path)
    for kind in ("dense", "edges", "odd"):
        x, y, z = _rays(kind)
        assert torch.equal(plates(x, y, z), _evaluator(g, x, y, z)), kind


def test_a_division_by_a_number_is_a_product_by_its_float_reciprocal(tapes):
    """torch's card divides by a host number as a product by its reciprocal
    in float32 (the CPU divides): K14 writes the reciprocal's bits."""
    src = script_tape.plate_function(tapes["scalar_div"][1])
    for d in (3, 7):
        bits = int((np.float32(1) / np.float32(d)).view(np.uint32))
        assert re.search(rf"__fmul_rn\(v\d+, __int_as_float\(0x{bits:08x}\)\)", src), (d, src)
    assert "__fdiv_rn" not in src
    # a number over a ray: the reciprocal, then the product
    assert re.search(r"__fdiv_rn\(__int_as_float\(0x3f800000\), v\d+\)",
                     script_tape.plate_function(tapes["mod"][1]))


@pytest.mark.parametrize("name", list(TAPEABLE))
def test_no_product_can_be_fused_into_a_sum(tapes, name, monkeypatch, tmp_path):
    """Every float operation of the source is an IEEE intrinsic, never an
    operator nvcc could contract, and the library builds with
    ``--fmad=false``."""
    tape = tapes[name][1]
    body = script_tape.plate_function(tape)
    assert not re.search(r"v\d+\s*[-+*/]\s*[v_(]", body), body
    assert re.search(r"__f(mul|add|sub|div)_rn", body) or name == "constant"
    seen = []

    def compile_locked(library, deps, command, timeout=None):
        seen.append(command(tmp_path / "out.so"))
        return None

    monkeypatch.setattr(_build, "compile_locked", compile_locked)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(script_tape, "_libs", {})
    monkeypatch.setattr(script_tape.ctypes, "CDLL", lambda path: _FakeLib())
    script_tape.library_for(tape)
    assert "--fmad=false" in seen[0] and seen[0][-1].endswith(f"script_tape_{tape.digest}.cu")


class _FakeLib:
    class _Fn:
        pass

    def __init__(self):
        self.blinky_script_tape = self._Fn()


def test_the_library_is_named_by_the_scripts_tape(tapes, tmp_path, monkeypatch):
    """A library a tape: the same script records the same source and
    library (bound once a process, built once a checkout), a changed
    script another one."""
    builds = []

    def compile_locked(library, deps, command, timeout=None):
        if library.exists():
            return None
        library.write_text("built")
        builds.append(library.name)
        proc = subprocess.CompletedProcess([], 0, "", "")
        proc.seconds = 0.0
        return proc

    monkeypatch.setattr(_build, "compile_locked", compile_locked)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(script_tape, "_libs", {})
    monkeypatch.setattr(script_tape.ctypes, "CDLL", lambda path: _FakeLib())
    g, tape = tapes["lfast"]
    again = script_tape.record(script_tape.plates_fn(g), CPU)
    assert again.source == tape.source and again.digest == tape.digest
    n0 = script_tape.library_for.builds
    lib = script_tape.library_for(tape)
    assert script_tape.library_for(again) is lib and builds == [f"libblinky_script_tape_"
                                                                f"{tape.digest}.so"]
    monkeypatch.setattr(script_tape, "_libs", {})  # a new process, the same checkout
    script_tape.library_for(again)
    assert len(builds) == 1 and script_tape.library_for.builds == n0 + 1
    changed = _globe(tmp_path, "lfast72", lua_drop_ins.LFAST.replace(
        "math.tan(math.pi / 4)", "math.tan(math.pi / 5)"))
    other = script_tape.record(script_tape.plates_fn(changed), CPU)
    assert other.digest != tape.digest
    script_tape.library_for(other)
    assert len(builds) == 2 and script_tape.library_for.builds == n0 + 2


@pytest.mark.parametrize("name, reason", [("repeat", "__bool__|any|item"),
                                          ("table", "__getitem__|index|table")])
def test_a_script_that_reads_its_lanes_is_not_tapeable(tmp_path, name, reason):
    """A data-dependent loop asks the card whether a lane is alive, and a
    lane-keyed table read gathers: neither records, the kernel keeps the
    evaluator, and its pieces are the evaluator's (the counters)."""
    g = _globe(tmp_path, name, {"repeat": REPEAT, "table": TABLE}[name])
    with pytest.raises(script_tape.NotTapeable, match=reason):
        script_tape.record(script_tape.plates_fn(g), CPU)
    refusals, tapes_n = script_tape.tape_of.refusals, script_tape.tape_of.tapes
    assert script_tape.tape_of(g, CPU) is None
    assert script_tape.tape_of.refusals == refusals + 1
    assert script_tape.tape_of.tapes == tapes_n
    assert re.search(reason, script_tape.tape_of.reason)


def _session(tmp_path, globe_name, src):
    d = tmp_path / "globes"
    d.mkdir(exist_ok=True)
    (d / f"{globe_name}.lua").write_text(src)
    sess = Session(64, 48, platesize=48, device="cpu", globe_dirs=[d])
    for line in ("fisheye 1", f"f_globe {globe_name}", "f_lens panini", "f_fov 160"):
        sess.cmd(line)
    return sess


def _posed(sess, B=5, seed=3):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (6, 48, 48, B), dtype=np.uint8))
    poses = np.stack([rng.uniform(-60, 60, B), rng.uniform(0, 360, B),
                      rng.uniform(-30, 30, B)], 1)
    return sess.render_posed(frames, poses)


@pytest.mark.parametrize("globe_name, src, tapeable", [
    ("lfast", lua_drop_ins.LFAST, True), ("odd", ODD, True),
    ("repeat", REPEAT, False), ("table", TABLE, False)])
def test_the_posed_kernel_records_its_scripts_tape(tmp_path, monkeypatch, globe_name, src,
                                                    tapeable):
    """A posed kernel on a script globe records its tape once, in set-up,
    as the span ``build.script_tape``, and the next call finds it kept; on
    the CPU every piece is the evaluator's (``tape_pieces`` stays),
    tapeable or not, and the screens are those of a globe without a tape."""
    sess = _session(tmp_path, globe_name, src)
    pieces, taped = static_ray.script_pose_plates.pieces, static_ray.script_pose_plates.tape_pieces
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _posed(sess)
    names = [e.key for e in prof.key_averages()]
    assert names.count("build.script_tape") == 1
    tapes_n, refusals = script_tape.tape_of.tapes, script_tape.tape_of.refusals
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert (script_tape.tape_of(sess.globe, CPU) is not None) == tapeable
    assert "build.script_tape" not in [e.key for e in prof.key_averages()]
    assert (script_tape.tape_of.tapes, script_tape.tape_of.refusals) == (tapes_n, refusals)
    assert static_ray.script_pose_plates.pieces > pieces
    assert static_ray.script_pose_plates.tape_pieces == taped
    monkeypatch.setattr(static_ray, "tape_of", lambda globe, device: None)
    assert torch.equal(_posed(sess), out)


def test_the_evaluators_refusal_refuses_the_tape_and_any_other_error_is_raised():
    """An ``Unvectorizable`` or ``LuaError`` of the evaluation leaves the
    script on the evaluator; any other exception (a fault of the recorder,
    of the device, of memory) reaches the caller instead of a quiet
    fallback."""
    from blinky_tpu_torch.lua_vector import Unvectorizable
    from blinky_tpu_torch.minilua import LuaError

    def raising(error):
        def fn(x, y, z):
            raise error
        return fn

    for error in (Unvectorizable("a lane-keyed call"), LuaError("bad script")):
        with pytest.raises(script_tape.NotTapeable, match=type(error).__name__):
            script_tape.record(raising(error), CPU)
    for error in (RuntimeError("CUDA error: an illegal memory access"), KeyError(3)):
        with pytest.raises(type(error)):
            script_tape.record(raising(error), CPU)


def test_tape_of_keeps_a_globes_tape_a_device(tapes, tmp_path):
    """A globe's tape is recorded at its first call on a device, and later
    calls return that same tape without recording; another globe of the
    same script records its own."""
    g = _globe(tmp_path, "lfast", lua_drop_ins.LFAST)
    n = script_tape.tape_of.tapes
    first = script_tape.tape_of(g, "cpu")
    assert first is not None and script_tape.tape_of.tapes == n + 1
    assert script_tape.tape_of(g, CPU) is first
    assert script_tape.tape_of.tapes == n + 1
    again = script_tape.tape_of(_globe(tmp_path, "lfast2", lua_drop_ins.LFAST), CPU)
    assert again is not first and again.digest == first.digest
    assert script_tape.tape_of.tapes == n + 2


def test_script_tape_checks_its_operands(tapes):
    tape = tapes["lfast"][1]
    x, y, z = _rays("dense")
    out = torch.empty(x.shape, dtype=torch.int8)
    with pytest.raises(ValueError, match="out must be a contiguous torch.int8"):
        script_tape.script_tape(tape, x, y, z, out.to(torch.int32))
    with pytest.raises(ValueError, match="z must be a contiguous torch.float32"):
        script_tape.script_tape(tape, x, y, z.double(), out)
    with pytest.raises(ValueError, match="y must be"):
        script_tape.script_tape(tape, x, y.t(), z, out)


def test_the_tape_holds_torchs_float32_constants(tapes):
    """A Lua number meeting a float32 ray is rounded to float32 as torch
    rounds it: lfast's ``dist`` and ``half`` are one float32."""
    nodes = tapes["lfast"][1].nodes
    muls = [n for n in nodes if n.op == "mul"]
    dist = 0.5 / math.tan(160 * math.pi / 180 / 2)
    assert all(a.value == dist for n in muls for a in n.args
               if isinstance(a, script_tape.Scalar))
    assert script_tape.literal(dist, torch.float32) == \
        f"__int_as_float(0x{int(np.float32(dist).view(np.uint32)):08x})"
    assert script_tape.literal(math.nan, torch.float32) == "__int_as_float(0x7fc00000)"
    assert script_tape.literal(-1, torch.int32) == "((int)-1LL)"
