"""The readings that the limits of ``correct`` are set from, for one cell:
the program's, and the control's, the reference put in the program's place
one precision down (float32 where the reference is float64; bfloat16 where
it is float32).  Each seed is a short window of the cell's own traffic and
the same check as a run's; all seeds in one process.

    python3 -m benchmark.control --workload <cell> --seconds 2 --seeds 1 2 3 [--program]

One JSON line a seed: the side, the seed, and each number compared.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seeds, seconds: float, program: bool, device="cuda:0",
             cfg_override=None, mix_override=None, spec=None):
    """Yield (seed, {check name: value}) for each seed."""
    import torch

    from benchmark import harness

    spec = spec or harness.benchmark_spec()
    for seed in seeds:
        _, run = harness.run_cell(spec, workload, seed, seconds, False, device=device,
                                  t_start=time.perf_counter(), cfg_override=cfg_override,
                                  mix_override=mix_override, control=not program)
        yield seed, {n: v for n, v, _ in run.checks}
        del run
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true",
                    help="read the program instead of the control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 2
    side = "program" if args.program else "control"
    for seed, checks in readings(args.workload, args.seeds, args.seconds, args.program):
        print(json.dumps({"side": side, "workload": args.workload, "seed": seed,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
