"""A minimal Lua 5.2 interpreter for lens/globe scripts.

The reference's user-scripting surface is arbitrary ``.lua`` lens/globe
files executed by an embedded Lua 5.2 VM (``init_lua`` / ``LUA_load_lens``
/ ``LUA_load_globe``, ``engine/NQ/fisheye.c:1222-1265,1659-1875``).  This
module restores that surface without linking Lua: a small tree-walking
interpreter covering the language subset the scripts use —

* values: nil, booleans, numbers (C doubles — Python floats), strings,
  tables, functions (closures);
* statements: (multi-)assignment incl. table element targets, ``local``,
  ``function`` definitions, ``if``/``elseif``/``else``, ``while``,
  ``repeat``/``until``, numeric ``for``, ``return``, ``break``, calls;
* expressions: full Lua operator precedence (``or`` < ``and`` <
  comparison < ``..`` < ``+ -`` < ``* / %`` < unary < ``^`` right-assoc),
  multiple-return expansion in the last position of expression lists,
  table constructors, short-circuit ``and``/``or`` with Lua value
  semantics, Lua truthiness (only ``nil``/``false`` are falsy);
* stdlib: the ``math`` table (through Python's ``math`` = the same libm
  the Lua VM calls), ``table.unpack``, ``print``, plus the alias globals
  the C host preloads (``cos = math.cos`` ... ``tau``, ``fisheye.c:1231-1248``).

Host builtins (``latlon_to_ray``, ``ray_to_latlon``, ``plate_to_ray``)
are injected by the loaders in :mod:`blinky_tpu_torch.lua_bridge`, with
the same ``vec3_t`` float32 pass-through the C wrappers have
(``CtoLUA_*``, ``fisheye.c:1494-1537``).

Execution is scalar by design — like the Lua VM itself.  The lens
loaders vectorize the resulting functions for the float64 host builder
(the ``Session`` default path), so a user's existing ``.lua`` script is
a drop-in.
"""

from __future__ import annotations

import math

from blinky_tpu_torch import lua_patterns as _lpat


class LuaError(ValueError):
    """Parse or runtime error in a Lua script."""


def _lua_typename(v) -> str:
    """Lua's type() name for a value (shared by diagnostics)."""
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)) or hasattr(v, "dtype"):
        return "number"  # incl. lane arrays/tracers: per-lane numbers
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    if isinstance(v, LuaCoroutine):
        return "thread"
    return "function"


# ---------------------------------------------------------------- lexer

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for",
    "function", "goto", "if", "in", "local", "nil", "not", "or", "repeat",
    "return", "then", "true", "until", "while",
}

_SYMBOLS = [
    "...", "..", "==", "~=", "<=", ">=", "#", "+", "-", "*", "/", "%",
    "^", "<", ">", "=", "(", ")", "{", "}", "[", "]", ";", "::", ":",
    ",", ".",
]


def _tokenize(src: str):
    toks = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if src.startswith("--", i):
            if src.startswith("--[[", i):  # long comment --[[ ... ]] / --]]
                end = src.find("]]", i + 4)
                if end < 0:
                    raise LuaError(f"line {line}: unterminated long comment")
                line += src.count("\n", i, end)
                i = end + 2
            else:
                end = src.find("\n", i)
                i = n if end < 0 else end
            continue
        if src.startswith("[[", i):  # long string [[ ... ]] (no nesting)
            end = src.find("]]", i + 2)
            if end < 0:
                raise LuaError(f"line {line}: unterminated long string")
            body = src[i + 2:end]
            if body.startswith("\n"):  # Lua drops a leading newline
                body = body[1:]
            line += src.count("\n", i, end)
            toks.append(("str", body, line))
            i = end + 2
            continue
        if c in "\"'":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    esc = src[j + 1]
                    if esc.isdigit():  # \ddd decimal byte escape
                        k = j + 1
                        while k < min(j + 4, n) and src[k].isdigit():
                            k += 1
                        buf.append(chr(int(src[j + 1:k])))
                        j = k
                        continue
                    buf.append({"n": "\n", "t": "\t", "r": "\r", "a": "\a",
                                "b": "\b", "f": "\f", "v": "\v",
                                "\\": "\\", '"': '"', "'": "'"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LuaError(f"line {line}: unterminated string")
            toks.append(("str", "".join(buf), line))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(("num", float(int(src[i:j], 16)), line))
                i = j
                continue
            seen_e = False
            while j < n and (src[j].isdigit() or src[j] == "."
                             or src[j] in "eE"
                             or (seen_e and src[j] in "+-" and src[j - 1] in "eE")):
                if src[j] in "eE":
                    seen_e = True
                j += 1
            try:
                num = float(src[i:j])
            except ValueError:
                raise LuaError(f"line {line}: malformed number {src[i:j]!r}") from None
            toks.append(("num", num, line))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            w = src[i:j]
            toks.append(("kw" if w in _KEYWORDS else "name", w, line))
            i = j
            continue
        for s in _SYMBOLS:
            if src.startswith(s, i):
                toks.append(("sym", s, line))
                i += len(s)
                break
        else:
            raise LuaError(f"line {line}: unexpected character {c!r}")
    toks.append(("eof", None, line))
    return toks


# --------------------------------------------------------------- parser
#
# AST nodes are plain tuples: (kind, ...).

class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.pos = 0
        # whether the enclosing function accepts `...` (the main chunk
        # is vararg in Lua); checked at PARSE time like the real VM so
        # a nested non-vararg closure can't read the outer varargs
        # through the env chain
        self._fn_vararg = [True]

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def check(self, kind, val=None):
        t = self.peek()
        return t[0] == kind and (val is None or t[1] == val)

    def accept(self, kind, val=None):
        if self.check(kind, val):
            return self.next()
        return None

    def expect(self, kind, val=None):
        t = self.next()
        if t[0] != kind or (val is not None and t[1] != val):
            raise LuaError(f"line {t[2]}: expected {val or kind}, got {t[1]!r}")
        return t

    # ---- statements

    def parse_chunk(self, terminators=("eof",)):
        stmts = []
        while True:
            while self.accept("sym", ";"):
                pass
            t = self.peek()
            if t[0] == "eof" or (t[0] == "kw" and t[1] in terminators):
                return ("block", stmts)
            stmts.append(self.parse_statement())
            if stmts[-1][0] in ("return", "break"):
                while self.accept("sym", ";"):
                    pass
                return ("block", stmts)

    def parse_statement(self):
        t = self.peek()
        if t[0] == "kw":
            if t[1] == "local":
                self.next()
                if self.accept("kw", "function"):
                    name = self.expect("name")[1]
                    return ("localfunc", name, self.parse_funcbody())
                names = [self.expect("name")[1]]
                while self.accept("sym", ","):
                    names.append(self.expect("name")[1])
                exprs = []
                if self.accept("sym", "="):
                    exprs = self.parse_exprlist()
                return ("local", names, exprs)
            if t[1] == "function":
                self.next()
                name = self.expect("name")[1]
                target = ("name", name)
                is_method = False
                while self.check("sym", ".") or self.check("sym", ":"):
                    is_method = self.next()[1] == ":"
                    key = self.expect("name")[1]
                    target = ("index", target, ("const", key))
                    if is_method:
                        break  # `a.b:c` — the method name ends the path
                fb = self.parse_funcbody(implicit_self=is_method)
                if target[0] == "name":
                    return ("funcstat", name, fb)
                return ("assign", [target], [fb])
            if t[1] == "if":
                self.next()
                arms = []
                cond = self.parse_expr()
                self.expect("kw", "then")
                body = self.parse_chunk(("elseif", "else", "end"))
                arms.append((cond, body))
                while self.accept("kw", "elseif"):
                    c = self.parse_expr()
                    self.expect("kw", "then")
                    arms.append((c, self.parse_chunk(("elseif", "else", "end"))))
                els = None
                if self.accept("kw", "else"):
                    els = self.parse_chunk(("end",))
                self.expect("kw", "end")
                return ("if", arms, els)
            if t[1] == "while":
                self.next()
                cond = self.parse_expr()
                self.expect("kw", "do")
                body = self.parse_chunk(("end",))
                self.expect("kw", "end")
                return ("while", cond, body)
            if t[1] == "repeat":
                self.next()
                body = self.parse_chunk(("until",))
                self.expect("kw", "until")
                cond = self.parse_expr()
                return ("repeat", body, cond)
            if t[1] == "for":
                self.next()
                var = self.expect("name")[1]
                if self.check("sym", ",") or self.check("kw", "in"):
                    # generic for: `for k[, v...] in explist do ... end`
                    names = [var]
                    while self.accept("sym", ","):
                        names.append(self.expect("name")[1])
                    self.expect("kw", "in")
                    exprs = self.parse_exprlist()
                    self.expect("kw", "do")
                    body = self.parse_chunk(("end",))
                    self.expect("kw", "end")
                    return ("forin", names, exprs, body)
                self.expect("sym", "=")
                start = self.parse_expr()
                self.expect("sym", ",")
                stop = self.parse_expr()
                step = None
                if self.accept("sym", ","):
                    step = self.parse_expr()
                self.expect("kw", "do")
                body = self.parse_chunk(("end",))
                self.expect("kw", "end")
                return ("fornum", var, start, stop, step, body)
            if t[1] == "return":
                self.next()
                exprs = []
                nxt = self.peek()
                if not (nxt[0] == "eof" or (nxt[0] == "kw" and nxt[1] in
                                            ("end", "else", "elseif", "until"))
                        or (nxt[0] == "sym" and nxt[1] == ";")):
                    exprs = self.parse_exprlist()
                return ("return", exprs)
            if t[1] == "break":
                self.next()
                return ("break",)
            if t[1] == "do":
                self.next()
                body = self.parse_chunk(("end",))
                self.expect("kw", "end")
                return ("do", body)
            if t[1] == "goto":
                self.next()
                return ("goto", self.expect("name")[1], t[2])
        if t[0] == "sym" and t[1] == "::":
            self.next()
            name = self.expect("name")[1]
            self.expect("sym", "::")
            return ("label", name, t[2])
        # expression statement: call, or (multi-)assignment
        first = self.parse_prefix_expr()
        if self.check("sym", "=") or self.check("sym", ","):
            targets = [first]
            while self.accept("sym", ","):
                targets.append(self.parse_prefix_expr())
            self.expect("sym", "=")
            exprs = self.parse_exprlist()
            for tgt in targets:
                if tgt[0] not in ("name", "index"):
                    raise LuaError(f"cannot assign to {tgt[0]}")
            return ("assign", targets, exprs)
        if first[0] != "call":
            raise LuaError(f"line {t[2]}: syntax error (unexpected expression)")
        return ("callstat", first)

    def parse_funcbody(self, implicit_self=False):
        self.expect("sym", "(")
        params = ["self"] if implicit_self else []
        vararg = False
        if not self.check("sym", ")"):
            while True:
                if self.accept("sym", "..."):
                    vararg = True
                    break  # `...` must be the last parameter
                params.append(self.expect("name")[1])
                if not self.accept("sym", ","):
                    break
        self.expect("sym", ")")
        self._fn_vararg.append(vararg)
        try:
            body = self.parse_chunk(("end",))
        finally:
            self._fn_vararg.pop()
        self.expect("kw", "end")
        return ("function", params, body, vararg)

    # ---- expressions

    def parse_exprlist(self):
        out = [self.parse_expr()]
        while self.accept("sym", ","):
            out.append(self.parse_expr())
        return out

    _BINPRI = {
        "or": 1, "and": 2,
        "<": 3, ">": 3, "<=": 3, ">=": 3, "~=": 3, "==": 3,
        "..": 4, "+": 5, "-": 5, "*": 6, "/": 6, "%": 6,
    }

    def parse_expr(self, limit=0):
        t = self.peek()
        if (t[0] == "sym" and t[1] in ("-", "#")) or (t[0] == "kw" and t[1] == "not"):
            op = self.next()[1]
            operand = self.parse_expr(7)  # unary level
            left = ("unop", op, operand)
        else:
            left = self.parse_simple_expr()
        while True:
            t = self.peek()
            if t[0] == "sym" and t[1] == "^":
                # ^ binds tighter than unary on the left, right-assoc
                self.next()
                right = self.parse_expr(7)
                left = ("binop", "^", left, right)
                continue
            op = t[1] if (t[0] == "sym" or t[0] == "kw") else None
            pri = self._BINPRI.get(op)
            if pri is None or pri <= limit:
                return left
            self.next()
            right = self.parse_expr(pri)
            left = ("binop", op, left, right)

    def parse_simple_expr(self):
        t = self.peek()
        if t[0] == "num":
            self.next()
            return ("const", t[1])
        if t[0] == "str":
            self.next()
            return ("const", t[1])
        if t[0] == "kw" and t[1] in ("nil", "true", "false"):
            self.next()
            return ("const", {"nil": None, "true": True, "false": False}[t[1]])
        if t[0] == "sym" and t[1] == "...":
            if not self._fn_vararg[-1]:
                raise LuaError(
                    f"line {t[2]}: cannot use '...' outside a vararg "
                    "function")
            self.next()
            return ("vararg",)
        if t[0] == "kw" and t[1] == "function":
            self.next()
            return self.parse_funcbody()
        if t[0] == "sym" and t[1] == "{":
            return self.parse_table()
        return self.parse_prefix_expr()

    def parse_table(self):
        self.expect("sym", "{")
        items = []  # ("pos", expr) | ("key", key_expr, val_expr)
        while not self.check("sym", "}"):
            if self.check("sym", "["):
                self.next()
                k = self.parse_expr()
                self.expect("sym", "]")
                self.expect("sym", "=")
                items.append(("key", k, self.parse_expr()))
            elif (self.check("name") and self.toks[self.pos + 1][0] == "sym"
                  and self.toks[self.pos + 1][1] == "="):
                name = self.next()[1]
                self.next()
                items.append(("key", ("const", name), self.parse_expr()))
            else:
                items.append(("pos", self.parse_expr()))
            if not (self.accept("sym", ",") or self.accept("sym", ";")):
                break
        self.expect("sym", "}")
        return ("table", items)

    def parse_prefix_expr(self):
        t = self.peek()
        if t[0] == "sym" and t[1] == "(":
            self.next()
            e = self.parse_expr()
            self.expect("sym", ")")
            node = ("paren", e)  # parens truncate multiple returns to one
        elif t[0] == "name":
            self.next()
            node = ("name", t[1])
        else:
            raise LuaError(f"line {t[2]}: unexpected token {t[1]!r}")
        while True:
            t = self.peek()
            if t[0] == "sym" and t[1] == ".":
                self.next()
                key = self.expect("name")[1]
                node = ("index", node, ("const", key))
            elif t[0] == "sym" and t[1] == "[":
                self.next()
                k = self.parse_expr()
                self.expect("sym", "]")
                node = ("index", node, k)
            elif t[0] == "sym" and t[1] == "(":
                self.next()
                args = []
                if not self.check("sym", ")"):
                    args = self.parse_exprlist()
                self.expect("sym", ")")
                node = ("call", node, args)
            elif t[0] == "sym" and t[1] == ":":
                self.next()
                name = self.expect("name")[1]
                if self.check("str"):  # obj:m"s" sugar
                    args = [("const", self.next()[1])]
                else:
                    self.expect("sym", "(")
                    args = []
                    if not self.check("sym", ")"):
                        args = self.parse_exprlist()
                    self.expect("sym", ")")
                node = ("methcall", node, name, args)
            elif t[0] == "str":  # f"string" call sugar — unused but cheap
                self.next()
                node = ("call", node, [("const", t[1])])
            else:
                return node


# ----------------------------------------------------------- interpreter

class LuaTable:
    """A Lua table: number/string-keyed dict (numeric keys normalized so
    ``t[1]`` and ``t[1.0]`` agree, as Lua 5.2 does).  ``get``/``set`` are
    RAW accesses (rawget/rawset); metamethod dispatch (``__index``,
    ``__newindex``, ...) lives in the interpreter, which is the only
    place with the call machinery."""

    __slots__ = ("data", "metatable", "vec_ctx")

    def __init__(self):
        self.data = {}
        self.metatable = None
        # the vectorized engine records the mask context a table was
        # constructed under (lua_vector's masked-setmetatable freshness
        # check); always None on the scalar engine
        self.vec_ctx = None

    @staticmethod
    def _norm(key, writing=False):
        if isinstance(key, bool):
            raise LuaError("boolean table keys unsupported")
        if isinstance(key, float):
            return int(key) if key.is_integer() else key
        if key is None:
            if writing:
                raise LuaError("table index is nil")  # Lua 5.2
            return None  # reads of t[nil] yield nil
        if hasattr(key, "shape") and hasattr(key, "dtype"):
            # arrays/tracers must never become dict keys (a traced key
            # would silently store a Tracer; a lane array is per-lane
            # control).  TypeError on purpose: the vectorized bridge's
            # fallback paths catch TypeError and re-run scalar.
            raise TypeError(
                f"table key must be a number or string, got "
                f"{type(key).__name__}")
        return key  # strings, tables, functions: legal Lua keys

    def get(self, key):
        k = self._norm(key)
        return None if k is None else self.data.get(k)

    def set(self, key, val):
        k = self._norm(key, writing=True)
        if val is None:
            self.data.pop(k, None)
        else:
            self.data[k] = val

    def length(self):
        n = 0
        while (n + 1) in self.data:
            n += 1
        return float(n)

    def array(self):
        """The 1..n contiguous array part as a Python list."""
        out = []
        i = 1
        while i in self.data:
            out.append(self.data[i])
            i += 1
        return out


def _lua_guard(name, f):
    """Convert stray Python exceptions from stdlib bodies into LuaError:
    the sandbox contract is that a script can only ever raise LuaError
    (pcall-able), never a raw TypeError/IndexError (e.g. table.sort over
    mixed types, format with missing args).  LuaError itself (a
    ValueError subclass) passes through."""
    def wrapped(*a):
        try:
            return f(*a)
        except LuaError:
            raise
        except (TypeError, ValueError, IndexError, KeyError,
                OverflowError, AttributeError) as e:
            raise LuaError(f"bad argument to '{name}' ({e})") from None
    wrapped.__name__ = name
    return wrapped


class _StubTable(LuaTable):
    """A library deliberately absent from the sandbox: indexing any key
    raises a precise diagnostic instead of a confusing nil-call error."""

    __slots__ = ("message",)

    def __init__(self, message):
        super().__init__()
        self.message = message

    def get(self, key):
        raise LuaError(self.message)


class LuaFunction:
    __slots__ = ("params", "body", "env", "interp", "name", "vararg")

    def __init__(self, params, body, env, interp, name="?", vararg=False):
        self.params = params
        self.body = body
        self.env = env
        self.interp = interp
        self.name = name
        self.vararg = vararg

    def __call__(self, *args):
        """Call from Python: returns None (no values), a single value, or
        a tuple of values — matching how the C host reads the stack."""
        vals = self.interp.call(self, list(args))
        if len(vals) == 0:
            return None
        if len(vals) == 1:
            return vals[0]
        return tuple(vals)


class _Env:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def lookup(self, name):
        e = self
        while e is not None:
            if name in e.vars:
                return e
            e = e.parent
        return None

    def root(self):
        e = self
        while e.parent is not None:
            e = e.parent
        return e


class _TableVars:
    """Dict-like view over a :class:`LuaTable` — the ``vars`` of a chunk
    environment created by ``load(chunk, name, mode, env)`` (the Lua 5.2
    ``_ENV`` argument).  Reads of nil-valued keys report absence, exactly
    like a missing global."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    def __contains__(self, k):
        return self.t.get(k) is not None

    def __getitem__(self, k):
        v = self.t.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __setitem__(self, k, v):
        self.t.set(k, v)

    def get(self, k, default=None):
        v = self.t.get(k)
        return default if v is None else v


class _CoKill(BaseException):
    """Injected at a suspended coroutine's yield point to unwind its
    thread when the owner discards it (``Interpreter.close``). BaseException
    so script-level pcall cannot swallow it."""


class LuaCoroutine:
    """A Lua 5.2 coroutine (``fisheye.c:278-280`` links full liblua, so a
    reference lens script may legitimately use them).

    Implementation: one daemon thread per coroutine with a strict
    handoff — exactly one of (resumer, coroutine) runs at any moment, so
    the interpreter's shared state (fuel, masks, globals) is never
    touched concurrently and execution stays deterministic.  The
    interpreter's ``_depth`` is context-switched at the handoff (each
    coroutine starts at depth 1) so suspending a coroutine can never
    re-arm the per-host-entry fuel reset.
    """

    __slots__ = ("fn", "interp", "status", "_thread", "_resume_evt",
                 "_return_evt", "_xfer", "_result", "_depth", "_kill")

    def __init__(self, fn, interp):
        import threading

        self.fn = fn
        self.interp = interp
        self.status = "suspended"
        self._thread = None
        self._resume_evt = threading.Event()
        self._return_evt = threading.Event()
        self._xfer = ()
        self._result = None  # ("yield"|"return", vals) | ("error", msg)
        self._depth = 1  # context-switched _depth: never the reset level
        self._kill = False

    # -- the coroutine thread's body
    def _main(self):
        try:
            out = self.interp.call(self.fn, list(self._xfer))
            self._result = ("return", out)
        except LuaError as e:
            self._result = ("error", str(e))
        except _CoKill:
            # unwound by close(); nobody is waiting — close() owns the
            # counter reset, and decrementing here would race a resumer
            self.interp._live_coroutines -= 1
            return
        except BaseException as e:  # sandbox contract: never leak raw
            self._result = ("error", f"{type(e).__name__}: {e}")
        # decrement BEFORE handing control back: the resumer is still
        # parked on _return_evt, so this write is inside the strict
        # handoff window.  Decrementing after set() raced the resumer's
        # cap-check/increment (a non-atomic RMW pair losing updates
        # drifts the counter up until the cap fires spuriously).
        self.interp._live_coroutines -= 1
        self._return_evt.set()

    def resume(self, args):
        """``coroutine.resume`` semantics: returns ``(True, *values)`` on
        yield/return, ``(False, message)`` on error or a bad state."""
        import threading

        if self.status == "dead":
            return (False, "cannot resume dead coroutine")
        if self.status != "suspended":
            return (False, "cannot resume non-suspended coroutine")
        interp = self.interp
        caller_depth = interp._depth
        stack = interp._co_stack
        cur = stack[-1] if stack else None
        if cur is not None:
            cur.status = "normal"
        stack.append(self)
        self.status = "running"
        interp._depth = self._depth
        self._xfer = tuple(args)
        if self._thread is None:
            if interp._live_coroutines >= interp.MAX_LIVE_COROUTINES:
                # unwind bookkeeping before erroring
                stack.pop()
                if cur is not None:
                    cur.status = "running"
                interp._depth = caller_depth
                self.status = "suspended"
                raise LuaError(
                    f"too many live coroutines "
                    f"(> {interp.MAX_LIVE_COROUTINES}); a sandboxed "
                    "script must let coroutines finish")
            interp._live_coroutines += 1
            self._thread = threading.Thread(
                target=self._main, name="minilua-coroutine", daemon=True)
            self._thread.start()
        else:
            self._resume_evt.set()
        self._return_evt.wait()
        self._return_evt.clear()
        # control is back: bank the coroutine's depth, restore the caller's
        self._depth = interp._depth
        stack.pop()
        if cur is not None:
            cur.status = "running"
        interp._depth = caller_depth
        kind, payload = self._result
        if kind == "yield":
            self.status = "suspended"
            return (True, *payload)
        self.status = "dead"
        # prune the interpreter's tracking list: a script that wraps a
        # coroutine per call (one per pixel on the scalar tier) would
        # otherwise retain every dead coroutine+thread+event triple for
        # the interpreter's lifetime — ~2M objects per 1080p build.
        # close() only needs the still-suspended ones.
        try:
            interp._all_coroutines.remove(self)
        except ValueError:
            pass  # already dropped (e.g. by close())
        if kind == "return":
            return (True, *payload)
        return (False, payload)

    def yield_(self, args):
        """Called on the coroutine's own thread by ``coroutine.yield``."""
        self._result = ("yield", tuple(args))
        self._return_evt.set()
        self._resume_evt.wait()
        self._resume_evt.clear()
        if self._kill:
            raise _CoKill()
        return self._xfer


class _Break(Exception):
    pass


class _Goto(Exception):
    """In-flight ``goto``: caught by the innermost enclosing block that
    defines the label (validated at parse time, so it never escapes the
    function)."""

    def __init__(self, label):
        self.label = label


def _validate_gotos(body):
    """Parse-time goto/label validation for one function body (Lua 5.2
    validates at parse: "no visible label ... for goto").  A label is
    visible to gotos in its own block and nested blocks; function
    bodies are separate scopes.  Duplicate labels in one block error."""

    def block_unresolved(blk):
        labels = set()
        for st in blk[1]:
            if isinstance(st, tuple) and st and st[0] == "label":
                if st[1] in labels:
                    raise LuaError(
                        f"line {st[2]}: label '{st[1]}' already defined")
                labels.add(st[1])
        unresolved = []
        for st in blk[1]:
            unresolved.extend(node_unresolved(st))
        return [g for g in unresolved if g[0] not in labels]

    def node_unresolved(node):
        if isinstance(node, list):
            out = []
            for x in node:
                out.extend(node_unresolved(x))
            return out
        if not isinstance(node, tuple) or not node:
            return []
        k = node[0] if isinstance(node[0], str) else None
        if k == "goto":
            return [(node[1], node[2])]
        if k == "function":  # a nested closure is its own goto scope
            _validate_gotos(node[2])
            return []
        if k == "block":
            return block_unresolved(node)
        rest = node[1:] if k else node
        out = []
        for sub in rest:
            out.extend(node_unresolved(sub))
        return out

    bad = block_unresolved(body)
    if bad:
        name, line = bad[0]
        raise LuaError(f"line {line}: no visible label '{name}' for goto")


class _Return(Exception):
    def __init__(self, vals):
        self.vals = vals


def _truthy(v):
    return v is not None and v is not False


def _num(v, what="operand"):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise LuaError(f"attempt to perform arithmetic on a non-number {what}")
    return float(v)


def _arith_coerce(v):
    """Number-or-None for the arithmetic fast path (no string->number
    coercion: a numeric string in arithmetic stays a script error here —
    the one deliberate divergence from liblua, keeping the scalar and
    vectorized engines trivially bit-equal)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


class Interpreter:
    """One interpreter = one script environment (the reference clears
    globals between loads, ``LUA_clear_lens/globe``, ``fisheye.c:1880-1903``)."""

    #: statements per top-level entry (run() or a host->Lua call). The
    #: real Lua VM would happily hang on `while true do end`; a bounded
    #: interpreter keeps a bad user script from freezing the session or
    #: the single-threaded viewer. Load-time script work and a single
    #: lens_inverse/forward call are thousands of statements at most.
    FUEL = 5_000_000

    #: live (started, not finished) coroutine threads per interpreter —
    #: the thread-count analog of FUEL: a script that parks thousands of
    #: coroutines would otherwise pin one blocked OS thread each.
    MAX_LIVE_COROUTINES = 200

    def __init__(self, builtins=None):
        self.globals = _Env()
        self.printed = []  # print() output (tetra.lua prints its fov)
        self._fuel = self.FUEL
        self._depth = 0
        self._co_stack = []  # innermost-running-coroutine stack
        self._live_coroutines = 0
        self._all_coroutines = []  # for close(): every coroutine created
        self._install_stdlib()
        if builtins:
            for k, v in builtins.items():
                self.globals.vars[k] = v

    def close(self):
        """Unwind any suspended coroutine threads (their frames reference
        the coroutine, so GC alone cannot reclaim them).  Safe to call on
        an interpreter that will not run scripts again; idempotent."""
        for co in self._all_coroutines:
            if co.status == "suspended" and co._thread is not None:
                co._kill = True
                co.status = "dead"
                co._resume_evt.set()
        for co in self._all_coroutines:
            if co._thread is not None:
                co._thread.join(timeout=5.0)
        self._all_coroutines.clear()

    # ---- environment setup

    def _install_stdlib(self):
        g = self.globals.vars
        mt = LuaTable()

        # Lua's math.* are raw libm calls: domain errors yield NaN and
        # log(0) yields -inf, where Python's math module raises.  Wrap to
        # the C semantics so boundary pixels behave like the reference
        # (e.g. mercator's log(tan(0)) at the pole).
        def _safe(f, on_overflow=math.inf):
            def g_(*a):
                try:
                    return f(*a)
                except ValueError:
                    return math.nan
                except OverflowError:
                    return on_overflow
                except ZeroDivisionError:
                    return math.nan
                except TypeError:
                    # Lua: "bad argument (number expected, got nil)" is a
                    # script error, not a raw Python TypeError
                    raise LuaError(
                        f"bad argument to {getattr(f, '__name__', 'math fn')}"
                        " (number expected)") from None
            return g_

        def _badarg(f, name):
            def g_(*a):
                try:
                    return f(*a)
                except (TypeError, ValueError):
                    raise LuaError(
                        f"bad argument to '{name}' (number expected)"
                    ) from None
            return g_

        def _log(x, base=None):
            if x == 0:
                return -math.inf  # C log(0)
            v = math.log(x) if base is None else math.log(x) / math.log(base)
            return v

        def _log10(x):
            return -math.inf if x == 0 else math.log10(x)

        def _pow(a, b):
            return float(a) ** float(b)

        mathfns = {
            "cos": _safe(math.cos), "sin": _safe(math.sin), "tan": _safe(math.tan),
            "acos": _safe(math.acos), "asin": _safe(math.asin),
            "atan": _safe(math.atan), "atan2": _safe(math.atan2),
            "sinh": _safe(math.sinh), "cosh": _safe(math.cosh),
            "tanh": _safe(math.tanh), "log": _safe(_log), "log10": _safe(_log10),
            "exp": _safe(math.exp), "sqrt": _safe(math.sqrt),
            "abs": _badarg(abs, "abs"),
            # C floor/ceil pass nan/inf through; Python's raise instead
            "floor": _badarg(lambda x: float(math.floor(x))
                             if math.isfinite(x) else float(x), "floor"),
            "ceil": _badarg(lambda x: float(math.ceil(x))
                            if math.isfinite(x) else float(x), "ceil"),
            "fmod": _safe(math.fmod), "pow": _safe(_pow),
            # nil/missing args are Lua script errors, not nan (and not a
            # raw Python TypeError)
            "max": _badarg(lambda *a: max(a), "max"),
            "min": _badarg(lambda *a: min(a), "min"),
            "modf": _badarg(lambda x: tuple(
                float(v) for v in reversed(math.modf(x))), "modf"),
            "rad": _badarg(math.radians, "rad"),
            "deg": _badarg(math.degrees, "deg"),
        }
        for k, v in mathfns.items():
            mt.set(k, v)
        mt.set("pi", math.pi)
        mt.set("huge", math.inf)
        g["math"] = mt

        tt = LuaTable()
        tt.set("unpack", lambda t: tuple(t.array()))

        def _t_insert(t, *a):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument to 'insert' (table expected)")
            if len(a) == 1:
                t.set(t.length() + 1, a[0])
            elif len(a) == 2:
                pos = int(a[0])
                n = int(t.length())
                for i in range(n, pos - 1, -1):
                    t.set(float(i + 1), t.get(float(i)))
                t.set(float(pos), a[1])
            else:
                raise LuaError("wrong number of arguments to 'insert'")

        def _t_remove(t, pos=None):
            n = int(t.length())
            if pos is None:
                if n == 0:
                    return None
                pos = n
            else:
                pos = int(pos)
                if n == 0:
                    if pos not in (0, 1):  # Lua 5.2 allows 0/1 on empty
                        raise LuaError(
                            "bad argument #1 to 'remove' "
                            "(position out of bounds)")
                    return None
                if not 1 <= pos <= n + 1:
                    raise LuaError(
                        "bad argument #1 to 'remove' (position out of bounds)")
                if pos == n + 1:
                    return None  # nothing shifts, nothing clears
            v = t.get(float(pos))
            for i in range(pos, n):
                t.set(float(i), t.get(float(i + 1)))
            t.set(float(n), None)
            return v

        def _t_concat(t, sep="", i=1, j=None):
            j = t.length() if j is None else j
            return str(sep).join(self._tostring(t.get(float(k)))
                                 for k in range(int(i), int(j) + 1))

        def _t_sort(t, comp=None):
            arr = t.array()
            if comp is None:
                arr.sort()
            else:
                import functools as _ft

                def cmp(a, b):
                    out = self.call(comp, [a, b])
                    return -1 if (out and _truthy(out[0])) else 1
                arr.sort(key=_ft.cmp_to_key(cmp))
            for k, v in enumerate(arr, 1):
                t.set(float(k), v)

        _guard = _lua_guard
        for name, f in (("insert", _t_insert), ("remove", _t_remove),
                        ("concat", _t_concat), ("sort", _t_sort),
                        ("unpack", tt.get("unpack"))):
            tt.set(name, _guard(name, f))
        g["table"] = tt
        g["unpack"] = tt.get("unpack")  # the 5.1 global alias
        g["print"] = self._print
        g["tostring"] = lambda v: self._tostring(v)

        def _tonumber(v, base=None):
            if base is not None:
                try:
                    return float(int(str(v).strip(), int(base)))
                except ValueError:
                    return None
            if isinstance(v, float):
                return v
            if isinstance(v, str):
                s = v.strip()
                try:
                    return float(int(s, 16)) if s[:2].lower() == "0x" \
                        else float(s)
                except ValueError:
                    return None
            return None

        _type = _lua_typename

        def _pairs(t):
            h = self._getmm(t, "__pairs")  # 5.2's __pairs protocol
            if h is not None:
                out = self.call(h, [t])
                out = (out + [None, None, None])[:3]
                return tuple(out)
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument to 'pairs' (table expected)")
            # key order snapshotted (Lua's order is unspecified; this one
            # is stable insertion order) but VALUES read live: mutations
            # of existing keys mid-traversal are seen, entries niled
            # during the loop are skipped — matching the reference VM
            it = iter(list(t.data.keys()))

            def step(s, ctrl):
                for k in it:
                    v = s.get(k)
                    if v is not None:
                        return (float(k) if isinstance(k, int) else k), v
                return None
            return step, t, None

        def _ipairs(t):
            h = self._getmm(t, "__ipairs")  # 5.2's __ipairs protocol
            if h is not None:
                out = self.call(h, [t])
                out = (out + [None, None, None])[:3]
                return tuple(out)
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument to 'ipairs' (table expected)")

            def step(s, i):
                i = float(i) + 1
                v = s.get(i)
                return None if v is None else (i, v)
            return step, t, 0.0

        def _select(n, *rest):
            if n == "#":
                return float(len(rest))
            k = int(n)
            if k < 0:
                k = len(rest) + 1 + k
            if k < 1:
                raise LuaError("bad argument to 'select' (index out of range)")
            return tuple(rest[k - 1:])

        def _error(msg=None, _level=None):
            raise LuaError(self._tostring(msg) if not isinstance(msg, str)
                           else msg)

        def _assert(v=None, msg=None, *rest):
            if not _truthy(v):
                raise LuaError(msg if isinstance(msg, str)
                               else "assertion failed!")
            return (v, msg, *rest) if msg is not None else v

        def _pcall(f, *a):
            try:
                out = self.call(f, list(a))
                return (True, *out)
            except LuaError as e:
                return False, str(e)

        g["tonumber"] = _guard("tonumber", _tonumber)
        g["type"] = _type
        g["pairs"] = _pairs
        g["ipairs"] = _ipairs
        g["select"] = _guard("select", _select)
        g["error"] = _error
        g["assert"] = _assert
        g["pcall"] = _pcall
        g["string"] = self._make_string_lib()

        # Explicit subset boundary: name the missing construct instead of
        # a confusing nil-call error (docs/SCRIPTING.md)
        def _unsupported(what, why):
            def f(*a):
                raise LuaError(f"{what} {why} (see docs/SCRIPTING.md)")
            return f

        # ---- metatables (fisheye.c:278-280 links real liblua; scripts
        # may use the full Lua 5.2 metamethod protocol)

        def _setmetatable(t, mt_=None):
            if not isinstance(t, LuaTable):
                raise LuaError(
                    "bad argument #1 to 'setmetatable' (table expected)")
            if mt_ is not None and not isinstance(mt_, LuaTable):
                raise LuaError("bad argument #2 to 'setmetatable' "
                               "(nil or table expected)")
            if (t.metatable is not None
                    and t.metatable.get("__metatable") is not None):
                raise LuaError("cannot change a protected metatable")
            t.metatable = mt_
            return t

        def _getmetatable(v=None):
            if isinstance(v, str):
                return self._string_meta
            if not isinstance(v, LuaTable) or v.metatable is None:
                return None
            prot = v.metatable.get("__metatable")
            return prot if prot is not None else v.metatable

        def _rawget(t, k=None):
            if not isinstance(t, LuaTable):
                raise LuaError(
                    "bad argument #1 to 'rawget' (table expected)")
            return t.get(k)

        def _rawset(t, k=None, v=None):
            if not isinstance(t, LuaTable):
                raise LuaError(
                    "bad argument #1 to 'rawset' (table expected)")
            t.set(k, v)
            return t

        def _rawlen(v=None):
            if isinstance(v, LuaTable):
                return v.length()
            if isinstance(v, str):
                return float(len(v))
            raise LuaError(
                "bad argument #1 to 'rawlen' (table or string expected)")

        def _next(t, key=None):
            if not isinstance(t, LuaTable):
                raise LuaError("bad argument #1 to 'next' (table expected)")
            keys = list(t.data.keys())
            if key is None:
                idx = 0
            else:
                k = LuaTable._norm(key)
                try:
                    idx = keys.index(k) + 1
                except ValueError:
                    raise LuaError("invalid key to 'next'") from None
            if idx >= len(keys):
                return None
            k2 = keys[idx]
            return ((float(k2) if isinstance(k2, int) else k2), t.data[k2])

        # deliberately NOT _guard-wrapped: an array/tracer key must keep
        # raising TypeError (LuaTable._norm's contract — the vectorized
        # bridge's fallback paths catch TypeError, and a LuaError here
        # would abort the build instead of engaging the scalar walk)
        g["setmetatable"] = _setmetatable
        g["getmetatable"] = _getmetatable
        g["rawget"] = _rawget
        g["rawset"] = _rawset
        g["rawequal"] = lambda a=None, b=None: self._eq(a, b)
        g["rawlen"] = _rawlen
        g["next"] = _next
        # the string metatable liblua installs (getmetatable("") reads it)
        self._string_meta = LuaTable()
        self._string_meta.set("__index", g["string"])

        for fname in ("require", "dofile", "loadfile", "collectgarbage"):
            g[fname] = _unsupported(
                f"'{fname}':", "not available to sandboxed lens scripts")
        for lib in ("io", "os"):
            g[lib] = _StubTable(
                f"the '{lib}' library is not available to sandboxed lens "
                "scripts (see docs/SCRIPTING.md)")

        # ---- coroutines + string chunks: pure-LANGUAGE liblua 5.2
        # surface (the reference links the full library,
        # fisheye.c:278-280); only the OS-bound libs above stay stubbed.

        def _co_create(f=None):
            if not (isinstance(f, LuaFunction) or callable(f)):
                raise LuaError(
                    "bad argument #1 to 'create' (function expected)")
            co = LuaCoroutine(f, self)
            self._all_coroutines.append(co)
            return co

        def _co_resume(co=None, *a):
            if not isinstance(co, LuaCoroutine):
                raise LuaError(
                    "bad argument #1 to 'resume' (coroutine expected)")
            return co.resume(a)

        def _co_yield(*a):
            import threading

            co = self._co_stack[-1] if self._co_stack else None
            if co is None or co._thread is not threading.current_thread():
                raise LuaError("attempt to yield from outside a coroutine")
            return co.yield_(a)

        def _co_status(co=None):
            if not isinstance(co, LuaCoroutine):
                raise LuaError(
                    "bad argument #1 to 'status' (coroutine expected)")
            return co.status

        def _co_wrap(f=None):
            co = _co_create(f)

            def wrapped(*a):
                out = co.resume(a)
                if out[0] is False:
                    raise LuaError(str(out[1]))
                return tuple(out[1:])

            return wrapped

        def _co_running():
            # 5.2 returns the main-thread object when called from the
            # main; we have no main-thread value, so (nil, true) — the
            # is-main boolean carries the usable signal (SCRIPTING.md)
            co = self._co_stack[-1] if self._co_stack else None
            return (co, co is None)

        def _co_isyieldable():
            import threading

            co = self._co_stack[-1] if self._co_stack else None
            return (co is not None
                    and co._thread is threading.current_thread())

        cot = LuaTable()
        for cname, cfn in (("create", _co_create), ("resume", _co_resume),
                           ("yield", _co_yield), ("status", _co_status),
                           ("wrap", _co_wrap), ("running", _co_running),
                           ("isyieldable", _co_isyieldable)):
            cot.set(cname, cfn)
        g["coroutine"] = cot

        def _load(chunk=None, chunkname=None, mode=None, env=None):
            if isinstance(chunk, str):
                src = chunk
            elif isinstance(chunk, LuaFunction) or callable(chunk):
                parts, total = [], 0
                while True:
                    piece = self._call1(chunk, [])
                    if piece is None or piece == "":
                        break
                    if not isinstance(piece, str):
                        return (None, "reader function must return a string")
                    total += len(piece)
                    if total > 10_000_000:
                        return (None, "chunk too large")
                    parts.append(piece)
                src = "".join(parts)
            else:
                raise LuaError("bad argument #1 to 'load' "
                               "(string or function expected)")
            if mode is not None:
                # isinstance first: `"t" not in 3.0` raises a raw
                # TypeError, which the sandbox must never leak (and
                # which lua_bridge's fallback clauses would misread as
                # an Unvectorizable verdict, demoting the whole lens)
                if not isinstance(mode, str):
                    raise LuaError(
                        "bad argument #3 to 'load' (string expected)")
                if "t" not in mode:
                    return (None,
                            "only text chunks are supported (mode 't')")
            name = chunkname if isinstance(chunkname, str) else "=(load)"
            try:
                ast = _Parser(_tokenize(src)).parse_chunk()
                _validate_gotos(ast)
            except LuaError as e:
                return (None, f"[string \"{name}\"]: {e}")
            fenv = self.globals
            if env is not None:
                # the 5.2 _ENV argument: the chunk's globals become the
                # given table (reads of nil keys = missing, like globals)
                if not isinstance(env, LuaTable):
                    raise LuaError(
                        "bad argument #4 to 'load' (table expected)")
                fenv = _Env()
                fenv.vars = _TableVars(env)
            return LuaFunction([], ast, fenv, self, name=name, vararg=True)

        def _loadstring(chunk=None, chunkname=None):
            if not isinstance(chunk, str):
                raise LuaError(
                    "bad argument #1 to 'loadstring' (string expected)")
            return _load(chunk, chunkname)

        g["load"] = _load
        g["loadstring"] = _loadstring  # the 5.1-compat alias 5.2 keeps

        # the alias preload block (init_lua, fisheye.c:1231-1248)
        for name in ("cos", "sin", "tan", "asin", "acos", "atan", "atan2",
                     "sinh", "cosh", "tanh", "log", "log10", "abs", "sqrt",
                     "exp", "pow"):
            g[name] = mt.get(name)
        g["pi"] = math.pi
        g["tau"] = math.pi * 2

    def _make_string_lib(self) -> "LuaTable":
        """The Lua 5.2 string library: format/sub/len/upper/lower/rep/
        reverse/byte/char plus the pattern functions (find/match/gmatch/
        gsub via :mod:`.lua_patterns` — the reference links real liblua,
        ``fisheye.c:278-280``, so user scripts may use any of these)."""
        st = LuaTable()

        def _s(v, fname):
            if isinstance(v, float):
                return self._tostring(v)  # Lua coerces numbers to strings
            if not isinstance(v, str):
                raise LuaError(f"bad argument to '{fname}' (string expected)")
            return v

        def _fmt(fmt, *args):
            fmt = _s(fmt, "format")
            out = []
            i, ai = 0, 0
            while i < len(fmt):
                c = fmt[i]
                if c != "%":
                    out.append(c)
                    i += 1
                    continue
                j = i + 1
                while j < len(fmt) and fmt[j] in "-+ #0123456789.":
                    j += 1
                if j >= len(fmt):
                    raise LuaError("invalid format string to 'format'")
                conv = fmt[j]
                spec = fmt[i:j + 1]
                if conv == "%":
                    out.append("%")
                elif conv in "diu":
                    out.append((spec[:-1] + "d") % int(float(args[ai])))
                    ai += 1
                elif conv in "eEfgG":
                    out.append(spec % float(args[ai]))
                    ai += 1
                elif conv in "xXoc":
                    out.append(spec % int(float(args[ai])))
                    ai += 1
                elif conv == "s":
                    out.append(spec % self._tostring(args[ai]))
                    ai += 1
                elif conv == "q":
                    s = self._tostring(args[ai])
                    ai += 1
                    out.append('"' + s.replace("\\", "\\\\")
                               .replace('"', '\\"').replace("\n", "\\n")
                               + '"')
                else:
                    raise LuaError(
                        f"invalid conversion '%{conv}' to 'format'")
                i = j + 1
            return "".join(out)

        def _range(s, i, j):
            """Lua 1-based, negative-from-end string range -> slice."""
            n = len(s)
            i = int(i)
            j = n if j is None else int(j)
            if i < 0:
                i = max(n + i + 1, 1)
            elif i == 0:
                i = 1
            if j < 0:
                j = n + j + 1
            elif j > n:
                j = n
            return (i, j)

        def _sub(v, i, j=None):
            s = _s(v, "sub")
            i, j = _range(s, i, j)
            return s[i - 1:j] if i <= j else ""

        def _byte(v, i=1.0, j=None):
            s = _s(v, "byte")
            i, j = _range(s, i, i if j is None else j)
            return tuple(float(ord(ch)) for ch in s[i - 1:j])

        st.set("format", _lua_guard("format", _fmt))
        st.set("sub", _lua_guard("sub", _sub))
        st.set("len", _lua_guard("len", lambda v: float(len(_s(v, "len")))))
        st.set("upper", _lua_guard("upper", lambda v: _s(v, "upper").upper()))
        st.set("lower", _lua_guard("lower", lambda v: _s(v, "lower").lower()))
        st.set("rep", _lua_guard("rep", lambda v, n, sep=None: (
            (str(sep) if sep is not None else "").join(
                [_s(v, "rep")] * int(n)))))
        st.set("reverse", _lua_guard(
            "reverse", lambda v: _s(v, "reverse")[::-1]))
        st.set("byte", _lua_guard("byte", _byte))
        st.set("char", _lua_guard(
            "char", lambda *a: "".join(chr(int(v)) for v in a)))

        # ---- Lua patterns (find/match/gmatch/gsub), lua_patterns.py

        def _caps_out(caps):
            """Captures -> Lua multi-value convention (tuple expands)."""
            if len(caps) == 1:
                return caps[0]
            return tuple(caps)

        def _find(v, p, init=None, plain=None):
            # explicit nil init = default 1 (liblua's luaL_optinteger)
            init = 1.0 if init is None else init
            r = _lpat.find(_s(v, "find"), _s(p, "find"), int(_num(init)),
                           _truthy(plain))
            if r is None:
                return None
            start, end, caps = r
            return (float(start), float(end), *caps)

        def _match_(v, p, init=None):
            init = 1.0 if init is None else init
            r = _lpat.match(_s(v, "match"), _s(p, "match"), int(_num(init)))
            return None if r is None else _caps_out(r)

        def _gmatch(v, p):
            it = _lpat.gmatch(_s(v, "gmatch"), _s(p, "gmatch"))

            def step(*_ignored):  # generic-for iterator protocol
                self._fuel -= 1
                if self._fuel < 0:
                    raise LuaError(
                        "instruction budget exhausted (runaway loop?)")
                try:
                    caps = next(it, None)
                except LuaError:
                    raise
                except ValueError as e:
                    # the generator evaluates lazily: a malformed
                    # pattern only surfaces at the first iteration,
                    # outside the _lua_guard wrapper — keep the sandbox
                    # contract (scripts only ever raise LuaError)
                    raise LuaError(
                        f"bad argument to 'gmatch' ({e})") from None
                return None if caps is None else _caps_out(caps)

            return step

        def _coerce_repl(rv, fname):
            """A table/function replacement value: nil/false keeps the
            original match; otherwise string or number (liblua's
            add_value)."""
            if rv is None or rv is False:
                return None
            if isinstance(rv, str):
                return rv
            if isinstance(rv, float) and not isinstance(rv, bool):
                return self._tostring(rv)
            raise LuaError(f"invalid replacement value (a "
                           f"{_lua_typename(rv)}) in '{fname}'")

        def _gsub(v, p, repl, n=None):
            s = _s(v, "gsub")
            pp = _s(p, "gsub")
            maxn = None if n is None else int(_num(n))
            if isinstance(repl, float) and not isinstance(repl, bool):
                repl = self._tostring(repl)
            if isinstance(repl, str):
                def value_of(whole, caps):
                    return _lpat.expand_repl(repl, whole, caps,
                                             self._tostring)
            elif isinstance(repl, LuaTable):
                def value_of(whole, caps):
                    # liblua looks up via lua_gettable: __index fires
                    return _coerce_repl(
                        self._index_value(repl, caps[0]), "gsub")
            elif callable(repl):
                def value_of(whole, caps):
                    out = self.call(repl, list(caps))
                    return _coerce_repl(out[0] if out else None, "gsub")
            else:
                raise LuaError("bad argument #3 to 'gsub' "
                               "(string/function/table expected)")
            return _lpat.gsub(s, pp, value_of, maxn)

        st.set("find", _lua_guard("find", _find))
        st.set("match", _lua_guard("match", _match_))
        st.set("gmatch", _lua_guard("gmatch", _gmatch))
        st.set("gsub", _lua_guard("gsub", _gsub))
        return st

    def _print(self, *args):
        self.printed.append("\t".join(self._tostring(a) for a in args))
        return None

    def _tostring(self, v):
        if isinstance(v, LuaTable):
            h = self._getmm(v, "__tostring")
            if h is not None:
                out = self._call1(h, [v])
                if not isinstance(out, str):
                    raise LuaError("'__tostring' must return a string")
                return out
            return f"table: 0x{id(v):012x}"
        if v is None:
            return "nil"
        if v is True:
            return "true"
        if v is False:
            return "false"
        if isinstance(v, float):
            return repr(v)
        if isinstance(v, str):
            return v
        if isinstance(v, LuaCoroutine):
            return f"thread: 0x{id(v):012x}"
        return f"function: 0x{id(v):012x}"

    # ---- public API

    def run(self, src: str) -> None:
        ast = _Parser(_tokenize(src)).parse_chunk()
        _validate_gotos(ast)
        self._depth += 1
        if self._depth == 1:
            self._fuel = self.FUEL
        try:
            self.exec_block(ast, self.globals)
        finally:
            self._depth -= 1

    def get_global(self, name):
        return self.globals.vars.get(name)

    def call(self, fn, args: list) -> list:
        if isinstance(fn, LuaFunction):
            env = _Env(fn.env)
            for i, p in enumerate(fn.params):
                env.vars[p] = args[i] if i < len(args) else None
            if fn.vararg:
                env.vars["..."] = tuple(args[len(fn.params):])
            self._depth += 1
            if self._depth == 1:
                self._fuel = self.FUEL
            try:
                self.exec_block(fn.body, env)
            except _Return as r:
                return r.vals
            except _Goto as gexc:  # unreachable post-validation; keep the
                # sandbox contract (scripts only ever raise LuaError)
                raise LuaError(
                    f"no visible label '{gexc.label}' for goto") from None
            finally:
                self._depth -= 1
            return []
        if callable(fn):
            out = fn(*args)
            if out is None:
                return [None] if fn in (None,) else []
            if isinstance(out, tuple):
                return list(out)
            return [out]
        if isinstance(fn, LuaTable):
            h = self._getmm(fn, "__call")
            if h is not None:
                return self.call(h, [fn] + list(args))
            raise LuaError("attempt to call a table value")
        raise LuaError(f"attempt to call a {_lua_typename(fn)} value")

    # ---- execution

    def exec_block(self, block, env):
        stmts = block[1]
        i = 0
        while i < len(stmts):
            try:
                self.exec_stmt(stmts[i], env)
            except _Goto as g:
                for j, st in enumerate(stmts):
                    if st[0] == "label" and st[1] == g.label:
                        i = j  # resume just after the label
                        break
                else:
                    raise  # a label in an enclosing block
            i += 1

    def exec_stmt(self, st, env):
        self._fuel -= 1
        if self._fuel < 0:
            raise LuaError("instruction budget exhausted (runaway loop?)")
        kind = st[0]
        if kind == "assign":
            vals = self.eval_list(st[2], env, want=len(st[1]))
            for tgt, val in zip(st[1], vals):
                self.assign(tgt, val, env)
        elif kind == "local":
            vals = self.eval_list(st[2], env, want=len(st[1]))
            for name, val in zip(st[1], vals):
                env.vars[name] = val
        elif kind == "callstat":
            self.eval_multi(st[1], env)
        elif kind == "if":
            for cond, body in st[1]:
                if _truthy(self.eval(cond, env)):
                    self.exec_block(body, _Env(env))
                    return
            if st[2] is not None:
                self.exec_block(st[2], _Env(env))
        elif kind == "while":
            try:
                while _truthy(self.eval(st[1], env)):
                    self._fuel -= 1  # empty bodies must still burn fuel
                    if self._fuel < 0:
                        raise LuaError(
                            "instruction budget exhausted (runaway loop?)")
                    self.exec_block(st[2], _Env(env))
            except _Break:
                pass
        elif kind == "repeat":
            try:
                while True:
                    self._fuel -= 1
                    if self._fuel < 0:
                        raise LuaError(
                            "instruction budget exhausted (runaway loop?)")
                    scope = _Env(env)  # until sees the body's locals
                    self.exec_block(st[1], scope)
                    if _truthy(self.eval(st[2], scope)):
                        break
            except _Break:
                pass
        elif kind == "fornum":
            start = _num(self.eval(st[2], env))
            stop = _num(self.eval(st[3], env))
            step = _num(self.eval(st[4], env)) if st[4] is not None else 1.0
            if step == 0:
                raise LuaError("'for' step is zero")
            v = start
            try:
                while (v <= stop) if step > 0 else (v >= stop):
                    scope = _Env(env)
                    scope.vars[st[1]] = v
                    self.exec_block(st[5], scope)
                    v += step
            except _Break:
                pass
        elif kind == "funcstat":
            fn = LuaFunction(st[2][1], st[2][2], env, self, st[1],
                             vararg=st[2][3])
            self.assign(("name", st[1]), fn, env)
        elif kind == "localfunc":
            env.vars[st[1]] = None
            fn = LuaFunction(st[2][1], st[2][2], env, self, st[1],
                             vararg=st[2][3])
            env.vars[st[1]] = fn
        elif kind == "forin":
            # generic for (the pairs/ipairs iterator protocol,
            # Lua 5.2 §3.3.5): f, s, ctrl = explist; loop on f(s, ctrl)
            f, s, ctrl = self.eval_list(st[2], env, want=3)
            try:
                while True:
                    self._fuel -= 1
                    if self._fuel < 0:
                        raise LuaError(
                            "instruction budget exhausted (runaway loop?)")
                    vals = self.call(f, [s, ctrl])
                    if not vals or vals[0] is None:
                        break
                    ctrl = vals[0]
                    scope = _Env(env)
                    for i, name in enumerate(st[1]):
                        scope.vars[name] = vals[i] if i < len(vals) else None
                    self.exec_block(st[3], scope)
            except _Break:
                pass
        elif kind == "return":
            raise _Return(self.eval_list(st[1], env, want=None))
        elif kind == "break":
            raise _Break()
        elif kind == "do":
            self.exec_block(st[1], _Env(env))
        elif kind == "label":
            pass  # jump target only
        elif kind == "goto":
            raise _Goto(st[1])
        else:
            raise LuaError(f"unknown statement {kind}")

    def assign(self, tgt, val, env):
        if tgt[0] == "name":
            e = env.lookup(tgt[1])
            (e if e is not None else env.root()).vars[tgt[1]] = val
        elif tgt[0] == "index":
            t = self.eval(tgt[1], env)
            if not isinstance(t, LuaTable):
                raise LuaError("attempt to index a non-table value")
            self._setindex(t, self.eval(tgt[2], env), val)
        else:
            raise LuaError(f"cannot assign to {tgt[0]}")

    # ---- evaluation

    def eval_list(self, exprs, env, want):
        """Evaluate an expression list with Lua's expansion rule: every
        position yields one value except the last, which expands if it is
        a call.  Pads with nil / truncates to *want* when given."""
        vals = []
        for i, e in enumerate(exprs):
            if i == len(exprs) - 1:
                vals.extend(self.eval_multi(e, env))
            else:
                vals.append(self.eval(e, env))
        if want is not None:
            while len(vals) < want:
                vals.append(None)
            vals = vals[:want]
        return vals

    def eval_multi(self, e, env) -> list:
        """Evaluate yielding ALL values (calls may return several)."""
        if e[0] == "call":
            fn = self.eval(e[1], env)
            args = self.eval_list(e[2], env, want=None)
            return self.call(fn, args)
        if e[0] == "methcall":
            obj = self.eval(e[1], env)
            fn = self._method(obj, e[2])
            args = self.eval_list(e[3], env, want=None)
            return self.call(fn, [obj] + args)
        if e[0] == "vararg":
            scope = env.lookup("...")
            if scope is None:
                raise LuaError("cannot use '...' outside a vararg function")
            return list(scope.vars["..."])
        return [self.eval(e, env)]

    # ---- metatables (the reference links real liblua, fisheye.c:278-280,
    # so user scripts may use the full Lua 5.2 metamethod protocol)

    @staticmethod
    def _getmm(v, event):
        """The metamethod for *event* on *v*, or None."""
        if isinstance(v, LuaTable) and v.metatable is not None:
            return v.metatable.get(event)
        return None

    def _call1(self, fn, args):
        out = self.call(fn, args)
        return out[0] if out else None

    def _index_value(self, t, key, depth=0):
        """``t[key]`` with ``__index`` chains (tables and strings)."""
        if depth > 100:
            raise LuaError("'__index' chain too long; possible loop")
        if isinstance(t, LuaTable):
            v = t.get(key)
            if v is not None:
                return v
            h = self._getmm(t, "__index")
            if h is None:
                return None
            if isinstance(h, LuaTable):
                return self._index_value(h, key, depth + 1)
            return self._call1(h, [t, key])
        if isinstance(t, str):
            # liblua gives strings a metatable with __index = string
            st = self.globals.vars.get("string")
            return st.get(key) if isinstance(st, LuaTable) else None
        raise LuaError("attempt to index a non-table value")

    def _setindex(self, t, key, val, depth=0):
        """``t[key] = val`` with ``__newindex`` chains."""
        if depth > 100:
            raise LuaError("'__newindex' chain too long; possible loop")
        if t.get(key) is None and t.metatable is not None:
            h = t.metatable.get("__newindex")
            if h is not None:
                if isinstance(h, LuaTable):
                    return self._setindex(h, key, val, depth + 1)
                self.call(h, [t, key, val])
                return
        t.set(key, val)

    _ARITH_EVENTS = {"+": "__add", "-": "__sub", "*": "__mul",
                     "/": "__div", "%": "__mod", "^": "__pow"}

    def _arith_event(self, op, a, b):
        """Arithmetic on non-numbers: the __add family, else error."""
        ev = self._ARITH_EVENTS[op]
        h = self._getmm(a, ev) or self._getmm(b, ev)
        if h is None:
            # name the truly non-numeric operand (a lane array/tracer
            # counts as a number — the scalar engine would blame the
            # table/nil/string side)
            def _nonnum(v):
                return _arith_coerce(v) is None and not hasattr(v, "dtype")
            bad = a if _nonnum(a) else b
            raise LuaError("attempt to perform arithmetic on a "
                           f"non-number operand ({_lua_typename(bad)})")
        return self._call1(h, [a, b])

    def _unm_value(self, v):
        nv = _arith_coerce(v)
        if nv is not None:
            return -nv
        h = self._getmm(v, "__unm")
        if h is not None:
            return self._call1(h, [v, v])  # 5.2 passes the operand twice
        raise LuaError("attempt to perform arithmetic on a "
                       f"non-number operand ({_lua_typename(v)})")

    def _len_value(self, v):
        if isinstance(v, LuaTable):
            h = self._getmm(v, "__len")
            if h is not None:
                return self._call1(h, [v])
            return v.length()
        if isinstance(v, str):
            return float(len(v))
        raise LuaError("attempt to get length of a non-table value")

    def _concat(self, a, b):
        def ok(v):
            return isinstance(v, str) or (isinstance(v, (int, float))
                                          and not isinstance(v, bool))
        if ok(a) and ok(b):
            sa = a if isinstance(a, str) else self._tostring(a)
            sb = b if isinstance(b, str) else self._tostring(b)
            return sa + sb
        h = self._getmm(a, "__concat") or self._getmm(b, "__concat")
        if h is not None:
            return self._call1(h, [a, b])
        bad = b if ok(a) else a
        raise LuaError(
            f"attempt to concatenate a {_lua_typename(bad)} value")

    def _mm_truth(self, v):
        """Truthiness of a comparison-metamethod result.  The vectorized
        engine overrides this: a lane-array result must not collapse to
        one uniform bool."""
        return _truthy(v)

    def _less(self, a, b, strict):
        both_num = (isinstance(a, (int, float)) and not isinstance(a, bool)
                    and isinstance(b, (int, float))
                    and not isinstance(b, bool))
        if both_num or (isinstance(a, str) and isinstance(b, str)):
            return (a < b) if strict else (a <= b)
        ev = "__lt" if strict else "__le"
        h = self._getmm(a, ev) or self._getmm(b, ev)
        if h is not None:
            return self._mm_truth(self._call1(h, [a, b]))
        if not strict:  # 5.2: a<=b falls back to not (b<a) through __lt
            h = self._getmm(a, "__lt") or self._getmm(b, "__lt")
            if h is not None:
                return not self._mm_truth(self._call1(h, [b, a]))
        raise LuaError(f"attempt to compare {_lua_typename(a)} with "
                       f"{_lua_typename(b)}")

    def _eq_value(self, a, b):
        if self._eq(a, b):
            return True
        if isinstance(a, LuaTable) and isinstance(b, LuaTable):
            # 5.2: the handler fires only when both metatables name the
            # SAME __eq (luaV_equalobj / get_equalTM)
            h = self._getmm(a, "__eq")
            if h is not None and h is self._getmm(b, "__eq"):
                return self._mm_truth(self._call1(h, [a, b]))
        return False

    def _method(self, obj, name):
        """Resolve ``obj:name`` — table methods (through ``__index``
        chains — the Class metatable OOP idiom), plus the string library
        on string values (Lua's string metatable)."""
        if isinstance(obj, LuaTable):
            fn = self._index_value(obj, name)
        elif isinstance(obj, str):
            st = self.globals.vars.get("string")
            fn = st.get(name) if isinstance(st, LuaTable) else None
        else:
            raise LuaError(f"attempt to call method {name!r} on a "
                           f"non-table value")
        if fn is None:
            raise LuaError(f"attempt to call a nil value (method {name!r})")
        return fn

    def eval(self, e, env):
        kind = e[0]
        if kind == "const":
            return e[1]
        if kind == "name":
            scope = env.lookup(e[1])
            return scope.vars[e[1]] if scope is not None else None
        if kind == "paren":
            return self.eval(e[1], env)
        if kind == "index":
            t = self.eval(e[1], env)
            if not isinstance(t, (LuaTable, str)):
                raise LuaError(f"attempt to index a non-table value ({e[1]})")
            return self._index_value(t, self.eval(e[2], env))
        if kind in ("call", "methcall", "vararg"):
            vals = self.eval_multi(e, env)
            return vals[0] if vals else None
        if kind == "function":
            return LuaFunction(e[1], e[2], env, self,
                               vararg=e[3] if len(e) > 3 else False)
        if kind == "table":
            t = LuaTable()
            pos = 0
            items = e[1]
            for i, item in enumerate(items):
                if item[0] == "key":
                    t.set(self.eval(item[1], env), self.eval(item[2], env))
                else:
                    if i == len(items) - 1:  # last positional expands
                        for v in self.eval_multi(item[1], env):
                            pos += 1
                            t.set(float(pos), v)
                    else:
                        pos += 1
                        t.set(float(pos), self.eval(item[1], env))
            return t
        if kind == "unop":
            if e[1] == "not":
                return not _truthy(self.eval(e[2], env))
            if e[1] == "-":
                return self._unm_value(self.eval(e[2], env))
            if e[1] == "#":
                return self._len_value(self.eval(e[2], env))
        if kind == "binop":
            op = e[1]
            if op == "and":
                left = self.eval(e[2], env)
                return self.eval(e[3], env) if _truthy(left) else left
            if op == "or":
                left = self.eval(e[2], env)
                return left if _truthy(left) else self.eval(e[3], env)
            a = self.eval(e[2], env)
            b = self.eval(e[3], env)
            if op == "==":
                return self._eq_value(a, b)
            if op == "~=":
                return not self._eq_value(a, b)
            if op == "..":
                return self._concat(a, b)
            if op == "<":
                return self._less(a, b, strict=True)
            if op == "<=":
                return self._less(a, b, strict=False)
            if op == ">":
                return self._less(b, a, strict=True)
            if op == ">=":
                return self._less(b, a, strict=False)
            na, nb = _arith_coerce(a), _arith_coerce(b)
            if na is None or nb is None:
                return self._arith_event(op, a, b)
            a, b = na, nb
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                # IEEE division, as the Lua VM's C double division:
                # the sign of a zero denominator matters (1/-0.0 = -inf)
                if b == 0:
                    if a == 0 or math.isnan(a):
                        return math.nan
                    return (math.inf
                            if math.copysign(1.0, a) == math.copysign(1.0, b)
                            else -math.inf)
                return a / b
            if op == "%":
                # Lua %: a - floor(a/b)*b, where floor is C floor
                # (floor(nan) = nan, floor(±inf) = ±inf — Python's
                # math.floor raises instead)
                if b == 0:
                    return math.nan
                q = a / b
                fq = math.floor(q) if math.isfinite(q) else q
                return a - fq * b
            if op == "^":
                # Lua ^ is C pow exactly.  Python's ** diverges on the
                # edges (OverflowError for huge |result| even when C pow
                # would return nan for neg^non-integer; complex for
                # neg**frac; ZeroDivisionError for 0^neg where C gives
                # +-inf) — map them all to the C99 results.
                if a == 0 and b < 0:
                    # C pow(+-0, y<0): +-inf for odd-integer y, +inf else
                    odd = (math.isfinite(b) and b == int(b)
                           and int(b) % 2 != 0)
                    neg_zero = math.copysign(1.0, a) < 0
                    return -math.inf if (odd and neg_zero) else math.inf
                try:
                    return math.pow(a, b)
                except ValueError:
                    return math.nan  # domain error: neg ^ non-integer
                except OverflowError:
                    # range error: C pow returns +-HUGE_VAL with the
                    # sign of the (finite) true result
                    odd = (math.isfinite(b) and b == int(b)
                           and int(b) % 2 != 0)
                    return -math.inf if (a < 0 and odd) else math.inf
        raise LuaError(f"cannot evaluate {kind}")

    @staticmethod
    def _eq(a, b):
        if isinstance(a, bool) or isinstance(b, bool):
            return a is b
        return a == b


def run_script(path_or_src, builtins=None, is_path=True) -> Interpreter:
    """Execute a Lua script and return its interpreter (for reading the
    resulting globals — the analog of ``LUA_load_lens``'s global reads)."""
    if is_path:
        from pathlib import Path

        src = Path(path_or_src).read_text()
    else:
        src = path_or_src
    interp = Interpreter(builtins=builtins)
    interp.run(src)
    return interp
