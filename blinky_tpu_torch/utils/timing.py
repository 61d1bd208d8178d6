"""Timing/observability helpers.

The reference exposes cvar-gated counters: ``host_speeds`` (per-stage ms,
``NQ/host.c:714-741``), ``show_fps`` (``common/screen.c:121,224-235``),
``r_speeds``/``r_dspeeds`` (``common/r_main.c:108,1081-1160``) and the
``timedemo`` end-to-end fps report (``NQ/cl_demo.c:364-382``).  These are
their batch-framework analogs: named wall-clock stage timers, a frame
throughput clock, and a ``torch.profiler`` trace.  A device barrier is
``torch.cuda.synchronize``: the port needs no fetch-based one.

:func:`span` marks a step of the program (a call into the ``Session``, a
kernel launch, a rebuild) for whatever profiler records the thread: it
costs one check while none does, and is a ``record_function`` range on the
profiler's clock while one does.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = nullcontext()


def span(name: str):
    """A context manager marking one step of the program as *name*.

    While a ``torch.profiler`` profile records this thread (the profile's
    state is thread-local: a thread it did not start on records nothing),
    the span is a ``torch.profiler.record_function`` range: it lands in the
    profile's Chrome trace on the clock of the card's kernels and copies,
    inside the span it is nested in on this thread.  Otherwise it is one
    shared null context, and the only cost is the check.  Names are dotted
    and start with their layer (``session.render``, ``launch.remap_gather``,
    ``build.lensmap``).  Nothing is kept in memory: :func:`profile_trace`
    is the way to see the spans."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorate a function so that each call of it is the :func:`span`
    *name*."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Timings:
    """Named stage timers, printed like ``host_speeds``."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def stage(self, name: str):
        """Time the block as *name*; under a profiler it is a :func:`span`
        too."""
        t0 = time.perf_counter()
        try:
            with span(name):
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
    Perfetto or ``chrome://tracing``.

    The trace holds the program's own spans (:func:`span`) beside the
    card's kernels and copies: each ``Session`` call, each kernel launch,
    each rebuild of a table, a kernel object or a library."""
    from pathlib import Path

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
