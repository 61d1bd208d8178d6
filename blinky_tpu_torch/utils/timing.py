"""Timing/observability helpers.

The reference exposes cvar-gated counters: ``host_speeds`` (per-stage ms,
``NQ/host.c:714-741``), ``show_fps`` (``common/screen.c:121,224-235``),
``r_speeds``/``r_dspeeds`` (``common/r_main.c:108,1081-1160``) and the
``timedemo`` end-to-end fps report (``NQ/cl_demo.c:364-382``).  These are
their batch-framework analogs: named wall-clock stage timers, a frame
throughput clock, and a ``torch.profiler`` trace.  A device barrier is
``torch.cuda.synchronize``: the port needs no fetch-based one.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timings:
    """Named stage timers, printed like ``host_speeds``."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        return "  ".join(
            f"{k}:{1000*v/max(1,self.counts[k]):.2f}ms" for k, v in self.totals.items()
        )


@contextmanager
def profile_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (the
    framework's ``r_dspeeds``-style deep inspection: per-kernel device
    timings) and write it to *logdir* as a Chrome trace, viewable in
    Perfetto or ``chrome://tracing``."""
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / f"trace_{time.time_ns()}.json"))


class FrameClock:
    """timedemo-style throughput: frames / seconds / fps
    (``CL_FinishTimeDemo``, ``NQ/cl_demo.c:364-382``)."""

    def __init__(self):
        self.frames = 0
        self.start = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        self.frames += n

    @property
    def seconds(self) -> float:
        return time.perf_counter() - self.start

    @property
    def fps(self) -> float:
        s = self.seconds
        return self.frames / s if s > 0 else 0.0

    def report(self) -> str:
        # "%i frames %5.1f seconds %5.1f fps" (cl_demo.c:381)
        return f"{self.frames} frames {self.seconds:5.1f} seconds {self.fps:5.1f} fps"
