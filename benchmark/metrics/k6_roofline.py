"""K6's share of its FP32 operation bound over the traced window: its
launches' operations (``k6_ops.ops`` on the reference's ray table) at the
card's FP32 rate, over the time of its kernel records."""

from benchmark.rooflines import share_of_op_bound

KERNEL = "static_ray_posed_kernel"


def read(run):
    if run.trace is None or "k6_ops" not in run.facts:
        return None
    recs = run.trace.kernels(KERNEL)
    return share_of_op_bound(run.facts["k6_ops"], len(recs), sum(r.end - r.start for r in recs))
