"""K1's share of its byte bound over the traced window: its launches'
bytes (``rooflines.gather_bytes`` on the reference's lensmap) at the
card's peak bandwidth, over the time of its kernel records."""

from benchmark.rooflines import share_of_bound

KERNEL = "remap_gather_kernel"


def read(run):
    if run.trace is None or "k1_bytes" not in run.facts:
        return None
    recs = run.trace.kernels(KERNEL)
    return share_of_bound(run.facts["k1_bytes"], len(recs), sum(r.end - r.start for r in recs))
