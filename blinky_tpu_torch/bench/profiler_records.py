"""How many device records ``torch.profiler`` keeps as a process ages.

    python -m blinky_tpu_torch.bench.profiler_records [--seconds 420] [--every 15]

Profiles 20 launches of one elementwise kernel again and again in one
process, every *--every* seconds for *--seconds*, in five ways: as is; with
a pause before the profile stops (``end.3``); with pauses at both ends
(``both.3``); with a pause after it starts (``start.3``); and with a
lead-in of 20 untimed launches split from the timed ones by a 50 ms pause
and a pause at the end (``lead+end.3``).  For each it prints the timed
launches' device records kept against their launches, and the first and
the last record's start less its launch's.  ``chip_smoke.py``'s
``profiled`` chooses its retries from what this prints.  It needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

N = 20  # timed launches a profile
VARIANTS = {"none": (0.0, 0.0, 0), "end.3": (0.0, 0.3, 0), "both.3": (0.3, 0.3, 0),
            "start.3": (0.3, 0.0, 0), "lead+end.3": (0.0, 0.3, N)}


def profile_once(x, pre, post, lead):
    """One profile of *N* launches on *x*, *pre* s of pause after it starts,
    *post* s before it stops, after *lead* untimed launches and a 50 ms
    pause; returns (timed records, timed launches, first record's start
    less the first launch's in ms, last's less the last's) or None for the
    two offsets when no record was kept."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pre)
        for _ in range(lead):
            x.mul_(1.0000001)
        if lead:
            torch.cuda.synchronize()
            time.sleep(0.05)
        for _ in range(N):
            x.mul_(1.0000001)
        torch.cuda.synchronize()
        time.sleep(post)
    ev = prof.events()
    gpu = sorted(e.time_range.start for e in ev if e.device_type.name == "CUDA")
    cpu = sorted(e.time_range.start for e in ev
                 if e.device_type.name == "CPU" and "LaunchKernel" in e.name)
    if lead and len(gpu) > 1:  # the timed records: those after the widest gap
        gaps = [b - a for a, b in zip(gpu, gpu[1:])]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        if gaps[i] > 20e3:
            gpu = gpu[i + 1:]
    cpu = cpu[lead:]
    if not gpu or not cpu:
        return len(gpu), len(cpu), None, None
    return len(gpu), len(cpu), (gpu[0] - cpu[0]) / 1e3, (gpu[-1] - cpu[-1]) / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=420.0)
    ap.add_argument("--every", type=float, default=15.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 1
    x = torch.randn(64 << 20, device="cuda")
    t0 = time.time()
    while True:
        t = time.time() - t0
        parts = []
        for name, v in VARIANTS.items():
            kept, launched, first, last = profile_once(x, *v)
            parts.append(f"{name} {kept}/{launched}" + (
                "" if first is None else f" [{first:+.2f}, {last:+.2f}] ms"))
        print(f"t={t:6.1f}s " + "; ".join(parts), flush=True)
        if t > args.seconds:
            return 0
        time.sleep(args.every)


if __name__ == "__main__":
    sys.exit(main())
