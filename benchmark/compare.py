"""The numbers ``correct`` compares."""


def worst_lane_mismatch(out, ref) -> float:
    """The largest share, over lanes, of screen pixels whose value differs
    from the reference's: *out* and *ref* are [pixels, lanes] of one dtype."""
    if out.shape != ref.shape:
        return 1.0
    differ = (out != ref).sum(dim=0)
    return float(differ.max()) / out.shape[0]
