"""Utilities: timing/observability (the reference's *_speeds analogs)."""

from blinky_tpu_torch.utils.timing import FrameClock, Timings  # noqa: F401
