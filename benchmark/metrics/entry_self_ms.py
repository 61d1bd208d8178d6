"""The host's own work a call into the program: the median, over the
program's outermost ``session.*`` spans wholly inside the traced window, of
the span's length less the union of the ``launch.*`` spans inside it, in
ms.  None when the trace holds no such span (a program without spans)."""

from bisect import bisect_left
from statistics import median

ENTRY, LAUNCH = "session.", "launch."


def _whole(trace, prefix):
    a, b = trace.window
    return [s for s in trace.spans if s.name.startswith(prefix) and a <= s.start and s.end <= b]


def _union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def calls(trace) -> list:
    """(length, [(start, end) of each launch span inside]) of each outermost
    entry span wholly inside the window, in seconds.  The program's spans
    nest on its one calling thread, so an entry span that starts before the
    last outermost one ends lies inside it."""
    outer, end = [], float("-inf")
    for s in sorted(_whole(trace, ENTRY), key=lambda s: (s.start, -s.end)):
        if s.start >= end:
            outer.append(s)
            end = s.end
    launches = sorted((x.start, x.end) for x in _whole(trace, LAUNCH))
    starts = [x[0] for x in launches]
    out = []
    for s in outer:
        i = bisect_left(starts, s.start)
        inside = []
        while i < len(launches) and launches[i][0] < s.end:
            if launches[i][1] <= s.end:
                inside.append(launches[i])
            i += 1
        out.append((s.end - s.start, inside))
    return out


def read(run):
    if run.trace is None:
        return None
    per_call = calls(run.trace)
    if not per_call:
        return None
    return 1e3 * median(length - _union_s(inside) for length, inside in per_call)
