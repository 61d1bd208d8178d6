"""The pieces a call of a script globe's plate stage takes: the median,
over the program's outermost ``session.*`` spans wholly inside the traced
window, of the ``posed.script_piece`` spans inside each (a piece is one
K13 launch and one evaluation of the script).  None without such a span
(a program without it)."""

from statistics import median

from benchmark.metrics.entry_self_ms import ENTRY

PIECE = "posed.script_piece"


def read(run):
    t = run.trace
    if t is None:
        return None
    a, b = t.window
    whole = sorted(((s.start, s.end, s.name) for s in t.spans if a <= s.start and s.end <= b),
                   key=lambda s: (s[0], -s[1]))
    pieces = [s for s, _, n in whole if n == PIECE]
    if not pieces:
        return None
    per_call, end = [], float("-inf")
    for s, e, n in whole:
        if n.startswith(ENTRY) and s >= end:  # an outermost entry span
            per_call.append(sum(s <= p < e for p in pieces))
            end = e
    return median(per_call) if per_call else None
