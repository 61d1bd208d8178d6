"""Lua 5.2 string-pattern matching for the mini-Lua sandbox.

The reference embeds real liblua (``init_lua``, ``engine/NQ/fisheye.c:
278-280``), so user scripts get the full ``string`` library including
Lua patterns.  This module restores that surface for :mod:`.minilua`
without linking Lua: a faithful re-implementation of the Lua 5.2
pattern matcher (the ``lstrlib.c`` semantics, documented in the Lua 5.2
manual section 6.4.1) —

* character classes ``%a %c %d %g %l %p %s %u %w %x`` (C locale /
  ASCII), uppercase complements, ``.``, literal ``%x`` escapes;
* sets ``[...]`` with ranges, embedded classes and ``^`` complement;
* quantifiers ``*`` ``+`` (greedy, backtracking), ``-`` (lazy), ``?``;
* anchors ``^`` and ``$``;
* captures incl. position captures ``()`` and back-references
  ``%1``–``%9``; at most 32 captures (LUA_MAXCAPTURES);
* ``%bxy`` balanced match and ``%f[set]`` frontier;
* the ``find`` / ``match`` / ``gmatch`` / ``gsub`` drivers with Lua's
  1-based, negative-from-end ``init`` handling and gsub's empty-match
  advancement rule.

Error messages mirror liblua's ("malformed pattern (ends with '%')",
"pattern too complex", ...) so scripts that pcall them behave the same.
Matching work is step-bounded (`MAX_STEPS`) for the same reason the
interpreter carries a fuel budget: a pathological pattern must raise,
never hang the single-threaded session.

Strings here are Python ``str`` treated as byte strings (scripts are
ASCII; chars compare by code point exactly as liblua's ``uchar``).
"""

from __future__ import annotations

MAXCAPTURES = 32
_MAXCCALLS = 200        # liblua's recursion bound -> "pattern too complex"
MAX_STEPS = 4_000_000   # sandbox fuel for one find/match/gsub call

_CAP_UNFINISHED = -1
_CAP_POSITION = -2


class PatternError(ValueError):
    """Malformed pattern / replacement (maps to LuaError in minilua)."""


# --------------------------------------------------- C-locale char classes

def _isalpha(o):
    return 65 <= o <= 90 or 97 <= o <= 122


def _isdigit(o):
    return 48 <= o <= 57


def _match_class(o: int, cl: str) -> bool:
    cll = cl.lower()
    if cll == "a":
        res = _isalpha(o)
    elif cll == "c":
        res = o < 32 or o == 127
    elif cll == "d":
        res = _isdigit(o)
    elif cll == "g":
        res = 33 <= o <= 126
    elif cll == "l":
        res = 97 <= o <= 122
    elif cll == "p":
        res = 33 <= o <= 126 and not (_isalpha(o) or _isdigit(o))
    elif cll == "s":
        res = o in (32, 9, 10, 11, 12, 13)
    elif cll == "u":
        res = 65 <= o <= 90
    elif cll == "w":
        res = _isalpha(o) or _isdigit(o)
    elif cll == "x":
        res = _isdigit(o) or 65 <= o <= 70 or 97 <= o <= 102
    else:
        return ord(cl) == o  # escaped literal (%%, %., %( ...)
    return res != cl.isupper()


# ------------------------------------------------------------ match state

class _MatchState:
    __slots__ = ("src", "p", "level", "capture", "matchdepth", "steps")

    def __init__(self, src: str, p: str):
        self.src = src
        self.p = p
        self.level = 0
        self.capture = []  # list of [init_index, len_or_flag]
        self.matchdepth = _MAXCCALLS
        self.steps = MAX_STEPS

    def _step(self):
        self.steps -= 1
        if self.steps < 0:
            raise PatternError("pattern matching budget exhausted "
                               "(runaway pattern?)")


def _class_end(ms: _MatchState, p: int) -> int:
    """Index just past the single-char class starting at pattern[p]."""
    pat = ms.p
    c = pat[p]
    p += 1
    if c == "%":
        if p >= len(pat):
            raise PatternError("malformed pattern (ends with '%')")
        return p + 1
    if c == "[":
        if p < len(pat) and pat[p] == "^":
            p += 1
        while True:  # look for the closing ']'
            if p >= len(pat):
                raise PatternError("malformed pattern (missing ']')")
            cc = pat[p]
            p += 1
            if cc == "%" and p < len(pat):
                p += 1  # skip escaped char (may be ']')
            if p < len(pat) and pat[p] == "]":
                break
            if p >= len(pat):
                raise PatternError("malformed pattern (missing ']')")
        return p + 1
    return p


def _match_bracket_class(o: int, ms: _MatchState, p: int, ec: int) -> bool:
    """Char code *o* vs the set pattern[p..ec] where pattern[p]=='[' and
    pattern[ec]==']' (liblua's matchbracketclass)."""
    pat = ms.p
    sig = True
    if pat[p + 1] == "^":
        sig = False
        p += 1
    p += 1
    while p < ec:
        if pat[p] == "%":
            p += 1
            if _match_class(o, pat[p]):
                return sig
            p += 1
        elif pat[p + 1] == "-" and p + 2 < ec:
            if ord(pat[p]) <= o <= ord(pat[p + 2]):
                return sig
            p += 3
        elif ord(pat[p]) == o:
            return sig
        else:
            p += 1
    return not sig


def _single_match(ms: _MatchState, s: int, p: int, ep: int) -> bool:
    ms._step()
    if s >= len(ms.src):
        return False
    o = ord(ms.src[s])
    c = ms.p[p]
    if c == ".":
        return True
    if c == "%":
        return _match_class(o, ms.p[p + 1])
    if c == "[":
        return _match_bracket_class(o, ms, p, ep - 1)
    return ord(c) == o


def _match_balance(ms: _MatchState, s: int, p: int):
    pat, src = ms.p, ms.src
    if p + 1 >= len(pat):
        raise PatternError("malformed pattern (missing arguments to '%b')")
    if s >= len(src) or src[s] != pat[p]:
        return None
    b, e = pat[p], pat[p + 1]
    cont = 1
    s += 1
    while s < len(src):
        ms._step()
        if src[s] == e:
            cont -= 1
            if cont == 0:
                return s + 1
        elif src[s] == b:
            cont += 1
        s += 1
    return None


def _check_capture(ms: _MatchState, ch: str) -> int:
    idx = ord(ch) - ord("1")
    if idx < 0 or idx >= ms.level or ms.capture[idx][1] == _CAP_UNFINISHED:
        raise PatternError(f"invalid capture index %{idx + 1}")
    return idx


def _capture_to_close(ms: _MatchState) -> int:
    for i in range(ms.level - 1, -1, -1):
        if ms.capture[i][1] == _CAP_UNFINISHED:
            return i
    raise PatternError("invalid pattern capture")


def _match(ms: _MatchState, s: int, p: int):
    """liblua's match(): returns the end index of the match of
    pattern[p:] at src[s:], or None.  Iterative over pattern items with
    bounded recursion for the backtracking points."""
    ms.matchdepth -= 1
    if ms.matchdepth == 0:
        raise PatternError("pattern too complex")
    try:
        pat, src = ms.p, ms.src
        while p < len(pat):  # "goto again" = continue
            ms._step()
            c = pat[p]
            if c == "(":
                if p + 1 < len(pat) and pat[p + 1] == ")":  # position capture
                    return _start_capture(ms, s, p + 2, _CAP_POSITION)
                return _start_capture(ms, s, p + 1, _CAP_UNFINISHED)
            if c == ")":
                return _end_capture(ms, s, p + 1)
            if c == "$" and p + 1 == len(pat):
                return s if s == len(src) else None
            if c == "%" and p + 1 < len(pat):
                nc = pat[p + 1]
                if nc == "b":
                    s2 = _match_balance(ms, s, p + 2)
                    if s2 is None:
                        return None
                    s, p = s2, p + 4
                    continue
                if nc == "f":
                    p += 2
                    if p >= len(pat) or pat[p] != "[":
                        raise PatternError(
                            "missing '[' after '%f' in pattern")
                    ep = _class_end(ms, p)
                    prev = ord(src[s - 1]) if s > 0 else 0
                    cur = ord(src[s]) if s < len(src) else 0
                    if (not _match_bracket_class(prev, ms, p, ep - 1)
                            and _match_bracket_class(cur, ms, p, ep - 1)):
                        p = ep
                        continue
                    return None
                if nc.isdigit():  # back-reference
                    idx = _check_capture(ms, nc)
                    init, ln = ms.capture[idx]
                    if (len(src) - s >= ln
                            and src[init:init + ln] == src[s:s + ln]):
                        s, p = s + ln, p + 2
                        continue
                    return None
                # else: escaped literal -> default single-char logic
            # default: single char class + optional quantifier
            ep = _class_end(ms, p)
            quant = pat[ep] if ep < len(pat) else ""
            if not _single_match(ms, s, p, ep):
                if quant in ("*", "?", "-"):
                    p = ep + 1
                    continue
                return None
            if quant == "?":
                res = _match(ms, s + 1, ep + 1)
                if res is not None:
                    return res
                p = ep + 1
                continue
            if quant == "+":
                return _max_expand(ms, s + 1, p, ep)
            if quant == "*":
                return _max_expand(ms, s, p, ep)
            if quant == "-":
                return _min_expand(ms, s, p, ep)
            s, p = s + 1, ep
        return s
    finally:
        ms.matchdepth += 1


def _start_capture(ms: _MatchState, s: int, p: int, what: int):
    if ms.level >= MAXCAPTURES:
        raise PatternError("too many captures")
    ms.capture.append([s, what])
    ms.level += 1
    res = _match(ms, s, p)
    if res is None:
        ms.level -= 1
        ms.capture.pop()
    return res


def _end_capture(ms: _MatchState, s: int, p: int):
    l = _capture_to_close(ms)
    ms.capture[l][1] = s - ms.capture[l][0]
    res = _match(ms, s, p)
    if res is None:
        ms.capture[l][1] = _CAP_UNFINISHED
    return res


def _max_expand(ms: _MatchState, s: int, p: int, ep: int):
    i = 0
    while _single_match(ms, s + i, p, ep):
        i += 1
    while i >= 0:
        res = _match(ms, s + i, ep + 1)
        if res is not None:
            return res
        i -= 1
    return None


def _min_expand(ms: _MatchState, s: int, p: int, ep: int):
    while True:
        res = _match(ms, s, ep + 1)
        if res is not None:
            return res
        if _single_match(ms, s, p, ep):
            s += 1
        else:
            return None


# ----------------------------------------------------------- capture read

def _one_capture(ms: _MatchState, i: int, s: int, e: int):
    if i >= ms.level:
        if i == 0:  # no explicit captures: whole match
            return ms.src[s:e]
        raise PatternError("invalid capture index")
    init, ln = ms.capture[i]
    if ln == _CAP_POSITION:
        return float(init + 1)
    if ln == _CAP_UNFINISHED:
        raise PatternError("unfinished capture")
    return ms.src[init:init + ln]


def _push_captures(ms: _MatchState, s, e) -> list:
    n = ms.level if (ms.level != 0 or s is None) else 1
    return [_one_capture(ms, i, s, e) for i in range(n)]


def _posrelat(pos: int, length: int) -> int:
    if pos >= 0:
        return pos
    if -pos > length:
        return 0
    return length + pos + 1


_SPECIALS = set("^$*+?.([%-")


# ------------------------------------------------------------- public API

def find(s: str, p: str, init: int = 1, plain: bool = False):
    """string.find: (start, end, captures list) 1-based, or None."""
    init = _posrelat(init, len(s))
    if init < 1:
        init = 1
    elif init > len(s) + 1:
        return None
    if plain or not any(ch in _SPECIALS for ch in p):
        idx = s.find(p, init - 1)
        if idx < 0:
            return None
        return (idx + 1, idx + len(p), [])
    ms = _MatchState(s, p)
    anchor = p.startswith("^")
    if anchor:
        ms.p = p = p[1:]
    s1 = init - 1
    while True:
        ms.level = 0
        ms.capture = []
        ms.matchdepth = _MAXCCALLS
        e = _match(ms, s1, 0)
        if e is not None:
            caps = _push_captures(ms, None, None) if ms.level else []
            return (s1 + 1, e, caps)
        s1 += 1
        if s1 > len(s) or anchor:
            return None


def match(s: str, p: str, init: int = 1):
    """string.match: list of captures (whole match if none), or None."""
    init = _posrelat(init, len(s))
    if init < 1:
        init = 1
    elif init > len(s) + 1:
        return None
    ms = _MatchState(s, p)
    anchor = p.startswith("^")
    if anchor:
        ms.p = p = p[1:]
    s1 = init - 1
    while True:
        ms.level = 0
        ms.capture = []
        ms.matchdepth = _MAXCCALLS
        e = _match(ms, s1, 0)
        if e is not None:
            return _push_captures(ms, s1, e)
        s1 += 1
        if s1 > len(s) or anchor:
            return None


def gmatch(s: str, p: str):
    """string.gmatch: generator of capture lists.  Like liblua, gmatch
    never strips a leading '^' (the manual: "a caret does not work as an
    anchor [in gmatch], as this would prevent the iteration"), so '^'
    here is an ordinary pattern character — a literal."""
    ms = _MatchState(s, p)
    src_pos = 0
    while src_pos <= len(s):
        ms.level = 0
        ms.capture = []
        ms.matchdepth = _MAXCCALLS
        e = _match(ms, src_pos, 0)
        if e is not None:
            start = src_pos
            src_pos = e if e > src_pos else src_pos + 1
            yield _push_captures(ms, start, e)
        else:
            src_pos += 1


def gsub(s: str, p: str, value_of, n=None):
    """string.gsub core: *value_of(whole, caps) -> str|None* supplies the
    replacement (None keeps the original match text).  Returns
    (result, count).  The %-expansion of string replacements is done by
    the caller via :func:`expand_repl`."""
    max_n = float("inf") if n is None else n
    ms = _MatchState(s, p)
    anchor = p.startswith("^")
    if anchor:
        ms.p = p = p[1:]
    out = []
    count = 0
    src = 0
    while count < max_n:
        ms.level = 0
        ms.capture = []
        ms.matchdepth = _MAXCCALLS
        e = _match(ms, src, 0)
        if e is not None:
            count += 1
            whole = s[src:e]
            rep = value_of(whole, _push_captures(ms, src, e))
            out.append(whole if rep is None else rep)
        if e is not None and e > src:
            src = e
        elif src < len(s):
            out.append(s[src])
            src += 1
        else:
            break
        if anchor:
            break
    out.append(s[src:])
    return "".join(out), float(count)


def expand_repl(repl: str, whole: str, caps: list, tostr) -> str:
    """Expand a gsub string replacement: %0 = whole match, %1-%9 =
    captures, %% = literal % (liblua's add_s)."""
    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        i += 1
        if i >= len(repl):
            raise PatternError("invalid use of '%' in replacement string")
        d = repl[i]
        if d == "%":
            out.append("%")
        elif d == "0":
            out.append(whole)
        elif d.isdigit():
            idx = int(d) - 1
            if idx >= len(caps):
                if idx == 0 and not caps:
                    out.append(whole)
                else:
                    raise PatternError("invalid capture index in "
                                       "replacement string")
            else:
                v = caps[idx]
                out.append(v if isinstance(v, str) else tostr(v))
        else:
            raise PatternError("invalid use of '%' in replacement string")
        i += 1
    return "".join(out)
