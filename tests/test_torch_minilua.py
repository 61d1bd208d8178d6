"""The port's Lua interpreter and pattern engine against the JAX package's.

``blinky_tpu_torch.minilua`` and ``blinky_tpu_torch.lua_patterns`` are
copies of ``blinky_tpu``'s, so every program the JAX package's Lua tests
run must run the same in both: each Lua source written in
``tests/test_minilua.py``, ``tests/test_lua_patterns.py`` and
``tests/test_lua_metatables.py`` (found by parsing those files, a chunk
the parser accepts) is one case here, and so is each (subject, pattern)
pair of ``test_lua_patterns.py``'s engine-level tables.  Tolerance 0: the
same printed lines, the same globals afterwards, the same error class and
message.  Addresses (``table: 0x...``) are the one thing that may differ,
and are masked.
"""

import ast
import math
import re
from pathlib import Path

import pytest

from blinky_tpu import lua_patterns as jlp
from blinky_tpu import minilua as jml
from blinky_tpu_torch import lua_patterns as plp
from blinky_tpu_torch import minilua as pml

TESTS = Path(__file__).parent
SOURCES = ("test_minilua.py", "test_lua_patterns.py", "test_lua_metatables.py")
FUEL = 20_000  # both interpreters stop a runaway program at the same statement


def _module_strings(tree):
    """Module-level ``NAME = "..."`` constants (``CLASS_SRC``)."""
    out = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant) and isinstance(node.value.value, str)):
            out[node.targets[0].id] = node.value.value
    return out


def _string_of(node, names):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return names.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _string_of(node.left, names), _string_of(node.right, names)
        return a + b if a is not None and b is not None else None
    return None


def _is_chunk(src):
    try:
        jml._Parser(jml._tokenize(src)).parse_chunk()
    except Exception:
        return False
    return bool(src.strip())


def _programs():
    progs = {}
    for fname in SOURCES:
        tree = ast.parse((TESTS / fname).read_text())
        names = _module_strings(tree)
        for node in ast.walk(tree):
            src = _string_of(node, names)
            if src is not None and src not in progs and _is_chunk(src):
                progs[src] = f"{fname}:{node.lineno}"
    return sorted(progs.items(), key=lambda kv: kv[1])


PROGRAMS = _programs()

_ADDR = re.compile(r"0x[0-9a-f]{6,}")


def _norm(text):
    return _ADDR.sub("0xADDR", text)


def _canon(v, mod, depth=0):
    """A Lua value as plain Python data, tables by content."""
    if isinstance(v, float) and math.isnan(v):
        return "nan"
    if isinstance(v, str):
        return _norm(v)
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, mod.LuaTable):
        if depth > 3:
            return "table"
        items = sorted(((repr(_canon(k, mod, depth + 1)), _canon(x, mod, depth + 1))
                        for k, x in v.data.items()), key=lambda kv: kv[0])
        return ("table", tuple(items), v.metatable is not None)
    if isinstance(v, tuple):
        return tuple(_canon(x, mod, depth) for x in v)
    return type(v).__name__


def _run(mod, src):
    it = mod.Interpreter()
    it.FUEL = FUEL
    fresh = set(mod.Interpreter().globals.vars)
    err = None
    try:
        it.run(src)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        err = (type(e).__name__, _norm(str(e)))
    try:
        printed = [_norm(p) for p in it.printed]
        glob = {k: _canon(v, mod) for k, v in sorted(it.globals.vars.items())
                if k not in fresh}
    finally:
        it.close()
    return printed, glob, err


def test_programs_were_found():
    """Every source file gives programs (the parser-based harvest works)."""
    found = {where.split(":")[0] for _, where in PROGRAMS}
    assert found == set(SOURCES)
    assert len(PROGRAMS) > 100


@pytest.mark.parametrize("src", [s for s, _ in PROGRAMS], ids=[w for _, w in PROGRAMS])
def test_program_runs_the_same(src):
    assert _run(pml, src) == _run(jml, src)


def _pattern_cases():
    """The (subject, pattern) pairs of test_lua_patterns.py's tables."""
    tree = ast.parse((TESTS / "test_lua_patterns.py").read_text())
    cases = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "parametrize"):
            continue
        names = [n.strip() for n in ast.literal_eval(node.args[0]).split(",")]
        if names[:2] != ["s", "p"]:
            continue
        for row in ast.literal_eval(node.args[1]):
            cases.append((row[0], row[1]))
    return cases


PATTERNS = _pattern_cases()


def _engine(lp, s, p):
    """find / match / gmatch / gsub of one pair, each result or its error."""
    out = []
    calls = (
        lambda: lp.find(s, p),
        lambda: lp.find(s, p, 2),
        lambda: lp.match(s, p),
        lambda: list(lp.gmatch(s, p)),
        lambda: lp.gsub(s, p, lambda whole, caps: lp.expand_repl("<%0>", whole, caps, str)),
    )
    for call in calls:
        try:
            out.append(("ok", call()))
        except Exception as e:  # noqa: BLE001 - the error itself is compared
            out.append((type(e).__name__, str(e)))
    return out


def test_pattern_cases_were_found():
    assert len(PATTERNS) >= 20


@pytest.mark.parametrize("s,p", PATTERNS)
def test_pattern_engine_same(s, p):
    assert _engine(plp, s, p) == _engine(jlp, s, p)
