"""K14's share of its byte bound over the traced window: its bytes a call
(``k14_bytes.nbytes``: the rotated unit rays read once, the int8 plates
written once, over the build grid of the configuration and the mix's
batch) times the calls, the program's ``posed.script_plates`` spans wholly
inside the window, at the card's peak bandwidth, over the time of K14's
kernel records.  A call launches K14 once a piece of the script's
evaluation.  None without the span, a record of K14 (a program that
evaluates the script otherwise, or the CPU) or the script cell's counts."""

from benchmark import k14_bytes
from benchmark.rooflines import share_of_bound

KERNEL = "script_tape_kernel"
SPAN = "posed.script_plates"


def read(run):
    t = run.trace
    if t is None or "k13_bytes" not in run.facts:
        return None
    recs = t.kernels(KERNEL)
    if not recs:
        return None
    a, b = t.window
    calls = sum(s.name == SPAN and a <= s.start and s.end <= b for s in t.spans)
    k = run.cfg.get("render_scale", 1)
    rays = (run.cfg["width"] // k) * (run.cfg["height"] // k)
    return share_of_bound(k14_bytes.nbytes(rays, run.mix["batch"]), calls,
                          sum(r.end - r.start for r in recs))
