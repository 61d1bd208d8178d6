"""K7's share of its byte bound over the traced window: its launches'
bytes (``k7_bytes.nbytes``: the frames read once, the pose-major copy
written once) at the card's peak bandwidth, over the time of its kernel
records."""

from benchmark.rooflines import share_of_bound

KERNEL = "posed_layout_"


def read(run):
    if run.trace is None or "k7_bytes" not in run.facts:
        return None
    recs = run.trace.kernels(KERNEL)
    return share_of_bound(run.facts["k7_bytes"], len(recs), sum(r.end - r.start for r in recs))
