"""The card's time a call in a script globe's plate stage: the traced
window's device busy time outside K6's and K7's kernel records, over the
program's outermost ``session.render_posed`` spans wholly inside the
window, in ms.  The window starts and ends with the card drained, and a
posed call on a script globe runs K7, the stage (K13 and the script's
evaluation, each piece's library kernels) and K6, so the stage's time is
what is left once K6 and K7 are taken out: its kernels are found by what
they are not, whatever names a library gives them.  None without a
``posed.script_plates`` span in the window (a program without it) or
without a device record (the CPU)."""

from benchmark.metrics.entry_self_ms import calls
from benchmark.metrics.k6_roofline import KERNEL as K6
from benchmark.metrics.k7_roofline import KERNEL as K7

SPAN = "posed.script_plates"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    a, b = t.window
    if not any(s.name == SPAN and a <= s.start and s.end <= b for s in t.spans):
        return None
    n = len(calls(t))
    if not n:
        return None
    busy, end = 0.0, float("-inf")
    for r in sorted((r for r in t.device if K6 not in r.name and K7 not in r.name),
                    key=lambda r: r.start):
        if r.end > end:
            busy += r.end - max(r.start, end)
            end = r.end
    return 1e3 * busy / n
