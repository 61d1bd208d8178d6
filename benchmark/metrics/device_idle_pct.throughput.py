"""Share of the traced window in which the card ran neither a kernel nor a
copy nor a fill."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
