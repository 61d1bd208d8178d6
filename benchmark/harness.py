"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics.  Everything a cell needs is found by name:

* ``BENCHMARK.json``'s ``workloads`` entry names a configuration and a
  traffic mix;
* the configuration is ``configs/<file>`` (its path in ``BENCHMARK.json``);
* the traffic mix is ``traffic/<mix>.json``, whose ``driver`` names the
  module ``drivers/<driver>.py`` that drives the program's entry point;
* each metric is read by ``metrics/<name>.py``'s ``read(run)``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as trace_mod

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "blinky_tpu")
LEAD_S = 0.5  # profiled but untraced: the profiler loses a profile's first records
TRACE_GAP_S = 0.25
TRACE_TAIL_S = 0.3


class Spans:
    """Host-clock spans around calls into the program.  While the profiler
    runs, each is also a ``record_function``, so it lands in the trace."""

    def __init__(self):
        self.records = []  # (name, start, end) in perf_counter seconds
        self.tracing = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(name) if self.tracing else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str, since: float = float("-inf"), until: float = float("inf")):
        return [b - a for n, a, b in self.records if n == name and a >= since and b <= until]


@dataclass
class Run:
    """What a run knows: its inputs, the program's state, and what it measured."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    spans: Spans = field(default_factory=Spans)
    state: dict = field(default_factory=dict)  # the driver's
    setup_s: float = 0.0
    window: tuple = (0.0, 0.0)  # perf_counter seconds
    calls: int = 0  # calls into the program inside the window
    screens: int = 0  # screens those calls rendered
    trace: trace_mod.Trace | None = None
    facts: dict = field(default_factory=dict)  # byte counts from the reference
    checks: list = field(default_factory=list)  # (name, value, limit)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark's folder, by path (a metric's
    name may hold a dot)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"{__package__}.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def resolve(spec: dict, workload: str) -> tuple:
    """(cell, configuration, traffic mix) of *workload*."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(REPO / cfg_entry["file"])
    mix = load_json(ROOT / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def metrics_for(spec: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics, or with
    *trace* its per-layer ones."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if "workloads" not in m or cell["name"] in m["workloads"]]


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _drive_until(run: Run, driver, t_end: float) -> None:
    while time.perf_counter() < t_end:
        driver.step(run)


def measure(run: Run, driver, seconds: float, trace: bool) -> None:
    """The window: closed-loop calls for *seconds*, then a sync, so all
    the work issued is done inside it.  With *trace*, the profiler runs
    over a lead-in, then over the traced part (``trace_seconds`` of the
    mix), marked by the window span."""
    run.calls = run.screens = 0
    t0 = time.perf_counter()
    run.window = (t0, t0)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        trace_s = float(run.mix.get("trace_seconds", 3.0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run.spans.tracing = True
            _drive_until(run, driver, time.perf_counter() + LEAD_S)
            driver.drain(run)
            time.sleep(TRACE_GAP_S)
            with torch.profiler.record_function(trace_mod.WINDOW):
                _drive_until(run, driver, time.perf_counter() + trace_s)
                driver.drain(run)
            time.sleep(TRACE_TAIL_S)
            run.spans.tracing = False
        run.trace = trace_mod.from_profile(prof)
    _drive_until(run, driver, t0 + seconds)
    driver.drain(run)
    run.window = (t0, time.perf_counter())


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, cfg_override: dict | None = None,
             mix_override: dict | None = None, control: bool = False) -> tuple:
    """One run of *workload*.  Returns (result line as a dict, Run).

    *cfg_override* / *mix_override* replace keys of the configuration and
    the mix (the CPU tests' small sizes); *control* puts the reference in
    the program's place, one precision down (``control.py``)."""
    cell, cfg, mix = resolve(spec, workload)
    cfg = {**cfg, **(cfg_override or {})}
    mix = {**mix, **(mix_override or {})}
    driver = load_module("drivers", mix["driver"])
    run = Run(cell, cfg, mix, int(seed), torch.device(device))
    driver.setup(run, control=control)
    run.synchronize()
    run.setup_s = time.perf_counter() - t_start
    measure(run, driver, seconds, trace)
    peak = (torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0)
    driver.check(run)  # frees the program's state first
    names = [m["name"] for m in metrics_for(spec, cell, trace)]
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    for name in names:
        value = load_module("metrics", name).read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    correct = all(v == v and v <= lim for _, v, lim in run.checks) and bool(run.checks)
    found = forbidden_modules()  # after the check and every reader: all that the run loaded
    if found:
        raise ImportError(f"the run loaded {', '.join(found)}")
    result = {
        "correct": correct,
        "attempted": run.calls,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(run.device, peak, run.trace if trace else None),
    }
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in run.checks}
    return result, run


def summary(run: Run) -> str:
    """One line on the window for standard error: its calls, and the
    quartiles of each span, in ms."""
    import numpy as np

    parts = [f"window {run.window_s:.3f} s, {run.calls} calls, {run.screens} screens"]
    names = sorted({n for n, _, _ in run.spans.records})
    series = {n: run.spans.durations(n, *run.window) for n in names}
    for n, d in series.items():
        if d:
            q = np.percentile(np.asarray(d) * 1e3, [25, 50, 75, 95])
            parts.append(f"{n} n={len(d)} ms q1/med/q3/p95 " + "/".join(f"{v:.3f}" for v in q))
    return "; ".join(parts)


def device_info(device: torch.device, peak: int, trace) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    return info
