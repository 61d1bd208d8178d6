"""Screens rendered in the window over its seconds: every call issued in it,
and the time until the card finished the last."""


def read(run):
    return run.screens / run.window_s if run.screens and run.window_s > 0 else None
