"""The port's bench entry point, on the card: ``python -m blinky_tpu_torch.bench``.

    python -m blinky_tpu_torch.bench                  # the headline: one JSON line
    python -m blinky_tpu_torch.bench --all [--quick] [--configs 0,2,5-7]
    python -m blinky_tpu_torch.bench --check [--quick] [--configs ...]
    python -m blinky_tpu_torch.bench --check-update [--quick] [--configs ...]
    python -m blinky_tpu_torch.bench --calibrate       # the memory walk
    python -m blinky_tpu_torch.bench --sol             # K3, K4 and the yardsticks
    python -m blinky_tpu_torch.bench --sharded         # batch and weak scaling

The headline is the texel-compacted 1080p remap (panini + cube, ``f_fov
180``, K1) at the batch the planner derives for this card
(``feasible_batch(..., budget=effective_budget_bytes(), quantum=QUANTUM)``),
printed as ``{"metric": "warped_1080p_frames_per_sec_per_chip", "value",
"unit", "batch", "config", ...}``.  It runs that source only: a failure, or
K1 differing from its plain version, exits non-zero.  ``--quick`` alone runs
``run_throughput`` at B = 128 instead, as the JAX entry point does, and
``--quick --headline-texels`` the headline.  Of the JAX entry point's
``--headline-*`` sources only the texel-compacted one is kept: the others
served its fallback chain, which the port does not have.

The flags ``--config4k-*``, ``--config-eq-*``, ``--config-rowcrop-*`` and
``--calibrate-probe N`` run one measurement each, in the processes the suite
and the walk start.  Every measurement holds its kernels to their plain
versions before it times them and exits non-zero when one differs
(``throughput.checked``).  ``--sharded`` runs the one-card batch scaling,
then the static and the posed weak scaling over the cards there are
(``run_sharded_scaling``, ``run_posed_sharded_scaling``: one row each on a
machine with one card).

Without a CUDA device it exits 1: the bench never measures the CPU.  With
``BLINKY_BENCH_LAUNCHES=<file>`` in the environment, every process of a run
appends one JSON line to that file at its end, with its argument list and
each kernel wrapper's launch count, so that a caller can show which kernels
a run went through.
"""

from __future__ import annotations

import json
import os
import sys

HEADLINE_METRIC = "warped_1080p_frames_per_sec_per_chip"
LAUNCHES_ENV = "BLINKY_BENCH_LAUNCHES"
USAGE = "--configs needs config indices 0-7, e.g. 0,2,5-7"


def parse_configs_arg(argv):
    """``--configs 0,2,5-7`` -> [0, 2, 5, 6, 7]; None when absent.  A missing
    or malformed spec, a reversed range, an index outside the suite or an
    empty selection exits with a usage line."""
    from blinky_tpu_torch.bench.configs import N_CONFIGS

    if "--configs" not in argv:
        return None
    try:
        spec = argv[argv.index("--configs") + 1]
    except IndexError:
        raise SystemExit(USAGE)
    out = []
    for part in spec.split(","):
        lo, sep, hi = part.partition("-")
        if not lo.isdigit() or (sep and not hi.isdigit()):
            raise SystemExit(f"--configs {spec!r}: malformed {part!r}; {USAGE}")
        lo, hi = int(lo), int(hi) if sep else int(lo)
        if lo > hi:
            raise SystemExit(f"--configs {spec!r}: reversed range {part!r}; {USAGE}")
        if hi >= N_CONFIGS:
            raise SystemExit(f"--configs {spec!r}: no config {hi}; {USAGE}")
        out.extend(range(lo, hi + 1))
    return out


def kernel_wrappers() -> dict:
    """Every kernel's wrapper, by the kernel's name in ``chip_smoke.py``'s
    kernels line; each counts its launches in ``.launches``."""
    from blinky_tpu_torch.bench import sol
    from blinky_tpu_torch.kernels import ingest, posed, remap, script_tape, static_ray
    from blinky_tpu_torch.lensmap import builder

    return {
        "remap_gather": remap.remap_gather, "remap_lut": remap.remap_lut,
        "onehot_gather": sol.onehot_gather, "stream_read": sol.stream_read,
        "posed_gather": posed.gather_posed, "static_ray_posed": static_ray.static_ray_posed,
        "posed_layout": posed.posed_layout, "lensmap_resolve": builder.lensmap_resolve,
        "sweep_remap": posed.sweep_remap, "equirect_gather": ingest.equirect_gather,
        "downsample_rgba": remap.downsample_rgba, "tint_expand_rgba": remap.tint_expand_rgba,
        "rotate_rays": builder.rotate_rays, "script_tape": script_tape.script_tape,
    }


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process, by name
    (:func:`kernel_wrappers`)."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def _record_launches(argv) -> None:
    path = os.environ.get(LAUNCHES_ENV)
    if path:
        with open(path, "a") as f:
            f.write(json.dumps({"argv": argv[1:], "launches": launch_counts()}) + "\n")


# the internal one-measurement flags: flag -> run_gather_throughput's
# arguments (quick batch, then the source), as the JAX entry point's
ROWCROP = {
    "--config-rowcrop-rubix": (96, dict(rubix=True, rgba=False, row_crop=True)),
    "--config-rowcrop-rgba": (48, dict(rubix=False, rgba=True, row_crop=True)),
    "--config-rowcrop-both": (32, dict(rubix=True, rgba=True, row_crop=True)),
    "--config-rowcrop-txrubix": (96, dict(rubix=True, rgba=False, texel_compact=True)),
    "--config-rowcrop-txrgba": (48, dict(rubix=False, rgba=True, texel_compact=True)),
    "--config-rowcrop-txboth": (32, dict(rubix=True, rgba=True, texel_compact=True)),
}


def _flag(argv, prefix):
    return next((a for a in argv if a.startswith(prefix)), None)


def run(argv) -> int:
    quick = "--quick" in argv
    if "--all" in argv:
        from blinky_tpu_torch.bench.configs import run_all

        for r in run_all(quick=quick, only=parse_configs_arg(argv)):
            print(json.dumps(r), flush=True)
        return 0
    if "--check" in argv or "--check-update" in argv:
        from blinky_tpu_torch.bench.check import run_check

        return run_check(quick=quick, update="--check-update" in argv,
                         only=parse_configs_arg(argv))
    if "--calibrate-probe" in argv:
        from blinky_tpu_torch.bench.calibrate import run_probe

        run_probe(int(argv[argv.index("--calibrate-probe") + 1]))
        return 0
    if "--calibrate" in argv:
        from blinky_tpu_torch.bench.calibrate import run_calibrate

        return run_calibrate()
    if "--sol" in argv:
        from blinky_tpu_torch.bench.sol import run_sol

        for r in run_sol():
            print(json.dumps({"metric": "speed_of_light_probe", **r}), flush=True)
        return 0
    if "--sharded" in argv:
        from blinky_tpu_torch.bench.throughput import (
            checked, run_batch_scaling, run_posed_sharded_scaling, run_sharded_scaling,
        )

        # the one-card batch scaling, then both weak scalings over the cards
        for r in run_batch_scaling():
            checked(r, f"batch scaling B={r['batch']}")
            print(json.dumps({"metric": "batch_scaling_1080p", **r}), flush=True)
        for r in run_sharded_scaling():
            checked(r, f"sharded scaling over {r['devices']} devices")
            print(json.dumps({"metric": "sharded_weak_scaling", **r}), flush=True)
        for r in run_posed_sharded_scaling():
            checked(r, f"posed sharded scaling over {r['devices']} devices")
            print(json.dumps({"metric": "posed_sharded_weak_scaling", **r}), flush=True)
        return 0

    from blinky_tpu_torch.bench.throughput import (
        checked, run_equirect_throughput, run_gather_throughput, run_throughput,
    )

    flag = _flag(argv, "--config4k-")
    if flag:
        rubix = flag == "--config4k-rubix"
        r = checked(run_gather_throughput(
            width=3840, height=2160, platesize=2160,
            batch=((32 if rubix else 64) if quick else None),
            iters=2 if quick else 4, rubix=rubix, rgba=False, compact=True))
        print(json.dumps({"fps": r["fps"], "config": r["config"], "batch": r["batch"]}))
        return 0
    flag = _flag(argv, "--config-eq-")
    if flag:
        r = checked(run_equirect_throughput(
            batch=128, iters=4, bilinear=not flag.endswith("nearest"),
            rubix=flag.endswith("rubix"), texel_compact=flag.endswith(("texels", "txrubix")),
            fused=flag.endswith(("fused", "fxrubix"))))
        print(json.dumps({"fps": r["fps"], "ms_per_batch": r["ms_per_batch"],
                          "config": r["config"]}))
        return 0
    flag = _flag(argv, "--config-rowcrop-")
    if flag:
        qbatch, kw = ROWCROP[flag]
        r = checked(run_gather_throughput(batch=qbatch if quick else None,
                                          iters=3 if quick else 6, **kw))
        print(json.dumps({"fps": r["fps"], "config": r["config"], "batch": r["batch"]}))
        return 0
    if quick and "--headline-texels" not in argv:
        batch = 128
        r = checked(run_throughput(batch=batch, iters=3))
    else:
        r = checked(run_gather_throughput(batch=None, iters=8, rubix=False, rgba=False,
                                          texel_compact=True))
        batch = r["batch"]
    keys = ("ms_per_batch", "bytes_per_batch", "gbps", "bound_bytes", "source_rows", "equal")
    print(json.dumps({"metric": HEADLINE_METRIC, "value": round(r["fps"], 1),
                      "unit": "frames/sec", "batch": batch, "config": r["config"],
                      **{k: r[k] for k in keys if k in r}}))
    return 0


def main(argv=None) -> int:
    import torch

    argv = sys.argv if argv is None else argv
    if not torch.cuda.is_available():
        print("blinky_tpu_torch.bench: no CUDA device; the bench measures the card only",
              file=sys.stderr)
        return 1
    try:
        return run(argv)
    finally:
        _record_launches(argv)


if __name__ == "__main__":
    sys.exit(main())
