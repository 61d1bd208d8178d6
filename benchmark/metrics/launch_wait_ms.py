"""The host's time inside the card's launches a call into the program: the
median, over the program's outermost ``session.*`` spans wholly inside the
traced window, of the summed ``launch.*`` spans inside each, in ms.  It
holds any wait for a free slot in the card's launch queue.  None when no
entry span holds a launch span (a program without spans; the CPU)."""

from statistics import median

from benchmark.metrics.entry_self_ms import calls


def read(run):
    if run.trace is None:
        return None
    per_call = calls(run.trace)
    if not any(inside for _, inside in per_call):
        return None
    return 1e3 * median(sum(b - a for a, b in inside) for _, inside in per_call)
