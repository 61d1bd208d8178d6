"""K13's share of its byte bound over the traced window: its bytes a call
(``k13_bytes.nbytes``: the ray table and the bases read once, the rotated
unit rays written once) times the calls, the program's
``posed.script_plates`` spans wholly inside the window, at the card's peak
bandwidth, over the time of K13's kernel records.  A call launches K13
once a piece of the script's evaluation, each launch reading the table
again; the count holds it once a call.  None without the span (a program
without it), a count or a record (the CPU)."""

from benchmark.rooflines import share_of_bound

KERNEL = "rotate_rays_kernel"
SPAN = "posed.script_plates"


def read(run):
    t = run.trace
    if t is None or "k13_bytes" not in run.facts:
        return None
    a, b = t.window
    calls = sum(s.name == SPAN and a <= s.start and s.end <= b for s in t.spans)
    recs = t.kernels(KERNEL)
    return share_of_bound(run.facts["k13_bytes"], calls, sum(r.end - r.start for r in recs))
