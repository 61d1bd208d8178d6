"""Measure the planner's bench budget on this card.

The port of :mod:`blinky_tpu.bench.calibrate`.  ``python -m
blinky_tpu_torch.bench --calibrate`` walks the texel-compacted 1080p
layout's batch axis in :data:`~blinky_tpu_torch.bench.autobatch.QUANTUM`
steps from the planner's derived batch up to the first out-of-memory, each
attempt in a process of its own, and reports the implied budget interval

    C_ok   = per_lane_bytes * last_feasible_B     (a measured run)
    C_fail = per_lane_bytes * first_failing_B     (a measured OOM)

as fractions of the card's memory, so that
``autobatch.EFFECTIVE_FRACTION`` is set below ``implied_fraction_lo``.
The result is written to ``bench_calibration.json`` beside this module,
with the card's name and power limit; the JAX package's file at the
repository root holds a v5e's numbers and is never read here.

A probe counts as out of memory only if its process died with PyTorch's
``torch.OutOfMemoryError`` message ("CUDA out of memory"); any other
death, or a timeout, aborts the walk and writes nothing.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

CALIBRATION_PATH = Path(__file__).resolve().parent / "bench_calibration.json"
ROOT = Path(__file__).resolve().parents[2]

#: the probed layout: texel-compacted u8 1080p (the headline's source), the
#: smallest lane of the production layouts, so a step is the finest.
WIDTH, HEIGHT, PLATESIZE = 1920, 1080, 1080


def probe_layout_bytes():
    """The probed layout's bytes a lane (its texels and one screen), from
    the exact host lensmap's compaction, as ``run_gather_throughput``
    counts them."""
    from blinky_tpu_torch import globes, lenses
    from blinky_tpu_torch.bench.autobatch import texels_bytes_per_lane
    from blinky_tpu_torch.budget import screen_bytes_per_lane
    from blinky_tpu_torch.kernels.remap import compact_texels
    from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, WIDTH, HEIGHT)
    lm = build_lensmap(lens, g, scale, WIDTH, HEIGHT, PLATESIZE)
    texels, _ = compact_texels(lm)
    return texels_bytes_per_lane(int(texels.size)) + screen_bytes_per_lane(WIDTH, HEIGHT)


def run_probe(batch: int, *, device="cuda") -> None:
    """(its own process) one attempt: the texel-compacted source at *batch*
    lanes and a full gather through K1.  Prints ``{"ok": true}``; running
    out of memory raises, and the parent reads the process's exit."""
    from blinky_tpu_torch.bench.throughput import run_gather_throughput

    r = run_gather_throughput(batch=batch, iters=1, rubix=False, rgba=False,
                              texel_compact=True, device=device)
    if not r["equal"]:
        raise RuntimeError(f"probe B={batch}: K1 differs from its plain version")
    print(json.dumps({"ok": True, "batch": batch}))


class CalibrationProbeError(RuntimeError):
    """A probe process failed for a reason that is not running out of
    memory (a timeout, a crash, an import error): the walk stops instead
    of recording it as the boundary."""


#: what a probe's output must hold to count as out of memory:
#: ``torch.OutOfMemoryError``'s message
_OOM_MARKERS = ("CUDA out of memory",)


def _spawn_probe(batch: int, timeout: float) -> bool:
    """Run :func:`run_probe` in a process of its own: True if it ran, False
    if it ran out of memory, :class:`CalibrationProbeError` otherwise."""
    try:
        subprocess.run(
            [sys.executable, "-m", "blinky_tpu_torch.bench", "--calibrate-probe", str(batch)],
            capture_output=True, text=True, timeout=timeout, check=True, cwd=ROOT)
        return True
    except subprocess.TimeoutExpired:
        raise CalibrationProbeError(
            f"probe B={batch} timed out after {timeout:.0f}s, not a measured OOM")
    except subprocess.CalledProcessError as e:
        err = (e.stderr or "") + (e.stdout or "")
        if any(m in err for m in _OOM_MARKERS):
            return False
        tail = err.strip().splitlines()[-3:]
        raise CalibrationProbeError(
            f"probe B={batch} died (exit {e.returncode}) without an OOM marker; "
            f"stderr tail: {' | '.join(tail) if tail else '<empty>'}")


def run_calibrate(probe=None, quantum=None, max_steps=None, timeout: float = 900.0, *,
                  device="cuda") -> int:
    """Walk B upward from the planner's derived batch until the first OOM;
    report the measured budget interval and where the committed
    ``EFFECTIVE_FRACTION`` sits in it.  ``probe(batch) -> bool`` is
    injectable for tests (default: :func:`_spawn_probe`).  *quantum*
    defaults to ``autobatch.QUANTUM``; *max_steps* defaults to enough steps
    to pass the card's whole memory (``device_hbm_bytes``) from the derived
    batch, so the walk ends in an OOM on any card the planner's budget
    does not already overfill."""
    from blinky_tpu_torch.bench import card_line
    from blinky_tpu_torch.bench.autobatch import (
        EFFECTIVE_FRACTION, QUANTUM, device_hbm_bytes, effective_budget_bytes,
    )
    from blinky_tpu_torch.budget import feasible_batch

    quantum = QUANTUM if quantum is None else int(quantum)
    if probe is None:
        probe = lambda b: _spawn_probe(b, timeout)  # noqa: E731
    per_lane = probe_layout_bytes()
    hbm = device_hbm_bytes(device)
    b0 = feasible_batch(per_lane, 0, budget=effective_budget_bytes(device), quantum=quantum)
    if max_steps is None:
        max_steps = max(math.ceil((hbm / per_lane - b0) / quantum), 0) + 1
    try:
        if not probe(b0):
            print(json.dumps({
                "metric": "hbm_calibration", "status": "error",
                "detail": f"derived batch B={b0} failed: the committed budget is "
                          "already over this card's capacity"}))
            return 1
        last_ok, first_fail = b0, None
        for step in range(1, max_steps + 1):
            b = b0 + step * quantum
            if probe(b):
                last_ok = b
            else:
                first_fail = b
                break
    except CalibrationProbeError as e:
        print(json.dumps({"metric": "hbm_calibration", "status": "error",
                          "detail": str(e)}))
        return 1
    out = {
        "metric": "hbm_calibration",
        "status": "ok" if first_fail is not None else "no-oom-found",
        "layout": f"texels-u8-{WIDTH}x{HEIGHT}",
        "per_lane_bytes": int(per_lane),
        "last_ok_batch": last_ok,
        "first_fail_batch": first_fail,
        "C_ok": int(per_lane * last_ok),
        "C_fail": None if first_fail is None else int(per_lane * first_fail),
        "implied_fraction_lo": round(per_lane * last_ok / hbm, 4),
        "implied_fraction_hi": (None if first_fail is None
                                else round(per_lane * first_fail / hbm, 4)),
        "committed_fraction": EFFECTIVE_FRACTION,
        "hbm_bytes": hbm,
        "card": card_line(),
    }
    if first_fail is None:
        out["detail"] = (f"no OOM within {max_steps} steps above the derived batch: "
                         "nothing written (a committed bench_calibration.json, if any, "
                         "is kept)")
        print(json.dumps(out))
        return 1
    lo, hi = out["implied_fraction_lo"], out["implied_fraction_hi"]
    out["committed_inside_interval"] = bool(lo <= EFFECTIVE_FRACTION <= hi)
    out["committed_vs_measured_pct"] = round((EFFECTIVE_FRACTION / lo - 1.0) * 100, 2)
    CALIBRATION_PATH.write_text(json.dumps(out, indent=1) + "\n")
    out["written"] = str(CALIBRATION_PATH)
    print(json.dumps(out))
    return 0
