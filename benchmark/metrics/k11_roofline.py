"""K11's share of its byte bound over the traced window: its launches'
bytes (``k11_bytes.nbytes``: the supersampled screen read once, the
filtered screen written once) at the card's peak bandwidth, over the time
of its kernel records."""

from benchmark.rooflines import share_of_bound

KERNEL = "downsample_kernel"


def read(run):
    if run.trace is None or "k11_bytes" not in run.facts:
        return None
    recs = run.trace.kernels(KERNEL)
    return share_of_bound(run.facts["k11_bytes"], len(recs), sum(r.end - r.start for r in recs))
