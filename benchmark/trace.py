"""The traced window: device records from ``torch.profiler`` and the
benchmark's own spans, on one timeline.

The harness marks the window with a span named :data:`WINDOW`; every span
of the benchmark is a ``record_function`` while the profiler runs, so its
host interval lands in the same trace as the card's kernels and copies.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Record:
    name: str
    cat: str
    start: float  # seconds on the trace's clock
    end: float
    nbytes: int = 0
    whole: bool = True  # False: cut to the window's edge


@dataclass
class Trace:
    window: tuple  # (start, end) seconds
    device: list = field(default_factory=list)  # Records on the card, clipped to the window
    spans: list = field(default_factory=list)  # Records of the benchmark's spans

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self, needle: str) -> list:
        """The kernel records whose name holds *needle* and that lie wholly
        inside the window."""
        return [r for r in self.device if r.cat == "kernel" and needle in r.name and r.whole]

    def busy_intervals(self) -> list:
        """The union of the device records' intervals, sorted."""
        out = []
        for r in sorted(self.device, key=lambda r: r.start):
            if out and r.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], r.end)
            else:
                out.append([r.start, r.end])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self) -> list:
        """(start, end) of each interval of the window with no device record."""
        gaps, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def span_at(self, t: float) -> str:
        """The innermost benchmark span (other than the window) open at *t*."""
        best = None
        for s in self.spans:
            if s.name != WINDOW and s.start <= t < s.end and (
                    best is None or s.start >= best.start):
                best = s
        return best.name if best else "outside any span"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        the span the host was in at the middle of each gap."""
        ops, idle = {}, {}
        for r in self.device:
            ops[r.name] = ops.get(r.name, 0.0) + (r.end - r.start)
        for a, b in self.idle_gaps():
            name = self.span_at((a + b) / 2)
            idle[name] = idle.get(name, 0.0) + (b - a)

        def first(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(ops), "idle_gaps": first(idle)}


def from_events(events: list) -> Trace:
    """A :class:`Trace` from a Chrome trace's ``traceEvents`` (times in
    microseconds)."""
    recs, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        r = Record(e.get("name", ""), e.get("cat", ""), e["ts"] * 1e-6,
                   (e["ts"] + e["dur"]) * 1e-6, int((e.get("args") or {}).get("bytes", 0) or 0))
        if r.cat in DEVICE_CATS:
            recs.append(r)
        elif r.cat == "user_annotation":
            spans.append(r)
            if r.name == WINDOW:
                window = (r.start, r.end)
    if window is None:
        raise ValueError(f"the trace has no {WINDOW} span")
    a, b = window
    inside = []
    for r in recs:
        if r.end > a and r.start < b:
            inside.append(Record(r.name, r.cat, max(r.start, a), min(r.end, b), r.nbytes,
                                 r.start >= a and r.end <= b))
    return Trace(window, inside, [s for s in spans if s.end > a and s.start < b])


def from_profile(prof) -> Trace:
    """Export *prof* (a finished ``torch.profiler.profile``) to a Chrome
    trace under ``$TMPDIR``, read it and delete it."""
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return from_events(data["traceEvents"] if isinstance(data, dict) else data)
