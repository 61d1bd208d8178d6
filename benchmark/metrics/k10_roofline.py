"""K10's share of its byte bound over the traced window: its launches'
bytes (``rooflines.equirect_gather_bytes`` on the reference's tables and
texel set) at the card's peak bandwidth, over the time of its kernel
records."""

from benchmark.rooflines import share_of_bound

KERNEL = "equirect_gather_kernel"


def read(run):
    if run.trace is None or "k10_bytes" not in run.facts:
        return None
    recs = run.trace.kernels(KERNEL)
    return share_of_bound(run.facts["k10_bytes"], len(recs), sum(r.end - r.start for r in recs))
