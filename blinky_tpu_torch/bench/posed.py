"""The posed path's bench tools: the seeded pose track, and K6's tuning sweep
and instruction count on one card.

    python -m blinky_tpu_torch.bench.posed [--out DIR]

The sweep builds ``csrc/posed.cu`` once per configuration of K6's tuning
constants (``K6_THREADS``, ``K6_POSES_PER_BLOCK``, ``K6_POSE_GROUP``,
``K6_MIN_BLOCKS``, set with ``nvcc -D``; every build started at once), holds
each build's K6 bit-equal to the package's own on the posed main path's
operands (``Session(1920, 1080)``, panini + cube, 64 seeded poses of the
synthetic 1080p batch), and times each beside the package's build, in turns,
for the u8 source at render scales 1 and 2.  Then it disassembles the
package's build (``cuobjdump -sass``) and counts the SASS instructions of
K6's pose-group loop for u8 at k = 1, per pose and build pixel, with the
regions the main path jumps over listed apart.  It needs a card, ``nvcc``
and ``cuobjdump``, and writes the SASS and ptxas's notes under ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from blinky_tpu_torch.kernels import _build

# each configuration overrides the source's defaults; the first is the source
CONFIGS = [
    {},
    {"K6_THREADS": 128, "K6_MIN_BLOCKS": 4, "K6_POSE_GROUP": 2},
    {"K6_THREADS": 256, "K6_MIN_BLOCKS": 2},
    {"K6_POSES_PER_BLOCK": 8},
    {"K6_POSES_PER_BLOCK": 32},
    {"K6_THREADS": 64, "K6_MIN_BLOCKS": 8},
    {"K6_MIN_BLOCKS": 3},
    {"K6_POSE_GROUP": 4},
]


def posed_poses(n, seed=6):
    """n seeded (pitch, yaw, roll) poses: yaw over 0-360, pitch over +-60,
    roll over +-30, with the identity first and (89, 180, 0) second."""
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(-60, 60, n), rng.uniform(0, 360, n),
                      rng.uniform(-30, 30, n)], axis=1)
    poses[0] = (0.0, 0.0, 0.0)
    poses[1] = (89.0, 180.0, 0.0)
    return poses


def _label(cfg):
    return ", ".join(f"{k}={v}" for k, v in cfg.items()) or "the source's defaults"


def _build_variants():
    """Start one nvcc per configuration, all at once, into the build
    directory; returns [(cfg, library path, ptxas log)]."""
    srcs = [str(_build.CSRC / "posed.cu"), str(_build.CSRC / "remap_gather.cu")]
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for i, cfg in enumerate(CONFIGS):
        lib = _build.BUILD_DIR / f"k6_variant{i}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in cfg.items()),
               "-o", str(lib), *srcs]
        procs.append((cfg, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    built = []
    for cfg, lib, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {_label(cfg)}:\n{log}")
        built.append((cfg, lib, log))
    return built


def _bind(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.blinky_static_ray_posed
    fn.argtypes = _build._SIGNATURES["blinky_static_ray_posed"]
    fn.restype = ctypes.c_int
    lib.blinky_error_string.argtypes = [ctypes.c_int]
    lib.blinky_error_string.restype = ctypes.c_char_p
    return lib


def sass_functions(sass):
    """``cuobjdump -sass`` text -> {function name: [(address, instruction)]}."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    return funcs


def loop_count(ins):
    """The widest loop of a function (its largest backward branch): its
    instructions, and the forward branches' regions inside it as (size,
    holds a CALL, first opcodes)."""
    back = [(a, int(m.group(1), 16)) for a, t in ins
            for m in [re.search(r"BRA (0x[0-9a-f]+)", t)] if m and int(m.group(1), 16) < a]
    end, head = max(back, key=lambda e: e[0] - e[1])
    body = [(a, t) for a, t in ins if head <= a <= end]
    regions = []
    for a, t in body:
        m = re.search(r"@!?U?P\d BRA (0x[0-9a-f]+)", t)
        if m and a < int(m.group(1), 16) <= end:
            skipped = [x for b, x in body if a < b < int(m.group(1), 16)]
            regions.append((len(skipped), any("CALL" in x for x in skipped),
                            " ".join(x.split()[0] for x in skipped[:6])))
    return len(body), regions


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/posed_sweep")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("posed sweep: no CUDA device", file=sys.stderr)
        return 1
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
    from blinky_tpu_torch.kernels import posed, static_ray

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {smi.strip()}", flush=True)
    home = _build.library()
    t0 = time.perf_counter()
    built = _build_variants()
    print(f"{len(built)} builds of posed.cu in {time.perf_counter() - t0:.1f} s", flush=True)
    for i, (cfg, _, log) in enumerate(built):
        (out_dir / f"k6_variant{i}.ptxas.txt").write_text(log)
        regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
        print(f"  variant {i} ({_label(cfg)}): registers {regs}, "
              f"spills {'none' if ' 0 bytes spill stores' in log else 'SOME'}")

    dev = torch.device("cuda")
    B, S = 64, 1080
    sess = Session(1920, 1080, device=dev)
    frames = torch.from_numpy(synthetic_cubemap_batch(S, B)).to(dev)
    poses = posed_poses(B)
    results = {}
    for k in (1, 2):
        sess.render_posed(frames, poses, render_scale=k)
        kern = sess._posed_cache[1]
        src, bases, expanded = posed.prep_posed_inputs(
            frames, posed.bases_from_pose_track(poses), S, kern.background, dev)
        call = lambda: static_ray.static_ray_posed(  # noqa: E731
            src, kern.ray_table, bases, kern.globe, S, kern.numcells, kern.cell_size,
            kern.pad_size, expanded, kern.background, k)
        ref = call()
        libs = [home] + [_bind(lib) for _, lib, _ in built]
        for i, lib in enumerate(libs[1:]):
            _build._lib = lib
            if not torch.equal(call(), ref):
                raise SystemExit(f"variant {i} ({_label(built[i][0])}) differs from "
                                 "the package's K6")
        # in turns: forwards, then backwards
        times = {i: [] for i in range(len(libs))}
        for order in (range(len(libs)), reversed(range(len(libs)))):
            for i in order:
                _build._lib = libs[i]
                times[i].append(cuda_ms(call, args.iters))
        _build._lib = home
        for i, ts in times.items():
            results.setdefault(i, {})[k] = float(np.mean(ts))
        del src, ref
    for i, ms in results.items():
        what = "the package's build" if i == 0 else f"variant {i - 1} ({_label(built[i - 1][0])})"
        print(f"K6 u8 1080p B={B}: {what}: k=1 {ms[1]:.4f} ms, k=2 {ms[2]:.4f} ms; bit-equal")

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.LIBRARY)], check=True,
                          capture_output=True, text=True).stdout
    for name, ins in sass_functions(sass).items():
        if "static_ray_posed_kernelIhLi1ELi0E" not in name:
            continue
        (out_dir / "k6_u8_k1_maxdot.sass").write_text(
            "\n".join(f"{a:04x} {t}" for a, t in ins) + "\n")
        n, regions = loop_count(ins)
        print(f"SASS of K6 u8 k=1 max-dot ({name}): {len(ins)} instructions, the pose-group "
              f"loop {n}; the regions its forward branches jump over:")
        for size, call, first in regions:
            print(f"  {size} instructions{' (holds a CALL)' if call else ''}: {first} ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
