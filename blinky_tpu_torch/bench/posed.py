"""The posed path's bench tools: the seeded pose track, and the tuning
sweeps and instruction counts of K6 and K13 on one card.

    python -m blinky_tpu_torch.bench.posed [--out DIR] [--what all|maxdot|given|k13|sass]
                                           [--against LIBRARY]

Each sweep builds one source once per configuration of its tuning
constants (set with ``nvcc -D``; every build of the run started at once),
holds each build's kernel bit-equal to the package's own, and times each
beside the package's build, in turns:

* ``maxdot``: K6 (``csrc/posed.cu``; ``K6_THREADS``, ``K6_POSES_PER_BLOCK``,
  ``K6_POSE_GROUP``, ``K6_MIN_BLOCKS``) on the posed main path's operands
  (``Session(1920, 1080)``, panini + cube, 64 seeded poses of the synthetic
  1080p batch), u8 at render scales 1 and 2: the cube, so K6 runs the max-dot
  select by the cube resolver (mode 3);
* ``given``: K6 in resolver mode 2 (``K6_POSES_PER_BLOCK``,
  ``K6_POSE_GROUP``; only mode 2 is timed) on the lfast script globe's plates
  (``bench/lua_drop_ins.py``), u8 at k = 1 and 2 and RGBA at k = 1;
* ``k13``: K13 (``csrc/lensmap.cu``; ``K13_THREADS``, ``K13_POSES``) on the
  same poses' rays at 1080p, B = 64, by CUDA events around launches of its
  C entry point, with the one-pose build's call and an 8-step sweep's
  unrotated tables beside it.

Then it disassembles the package's build (``cuobjdump -sass``) and counts
the SASS instructions of K6's pose-group loop for u8 at k = 1, max-dot,
mode 2 and mode 3 (the cube resolver), per pose and build pixel, with the
regions the main path jumps over listed apart, and the instructions of every
instantiation of K8 and K9.  ``--what sass`` does only that, with no sweep.
``--against`` names another build of the library (another checkout's): each
function of both is compared instruction by instruction, so a change to one
resolver can be shown to leave the others' code as it was.  It needs a
card, ``nvcc`` and ``cuobjdump``, and writes the SASS, ptxas's notes and the
printed lines (``posed_bench.txt``) under ``--out``.
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


# K6 in resolver mode 2 (the first is the source)
GIVEN_CONFIGS = [
    {},
    {"K6_POSES_PER_BLOCK": 8},
    {"K6_POSES_PER_BLOCK": 32},
    {"K6_POSES_PER_BLOCK": 64},
    {"K6_POSE_GROUP": 2},
    {"K6_POSES_PER_BLOCK": 32, "K6_POSE_GROUP": 2},
]
# K13 (the first is the source)
K13_CONFIGS = [
    {},
    {"K13_POSES": 8},
    {"K13_POSES": 16},
    {"K13_POSES": 64},
    {"K13_THREADS": 256},
    {"K13_THREADS": 512},
    {"K13_POSES": 64, "K13_THREADS": 256},
]
# the sources each sweep builds (remap_gather.cu has blinky_error_string)
SWEEP_SOURCES = {"maxdot": "posed.cu", "given": "posed.cu", "k13": "lensmap.cu"}
SWEEPS = {"maxdot": CONFIGS, "given": GIVEN_CONFIGS, "k13": K13_CONFIGS}


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


def _build_variants(sweeps):
    """Start one nvcc per configuration of each sweep named in *sweeps* (the
    source's own first configuration excepted: the package's build), all at
    once, into the build directory; returns {sweep: [(cfg, library path,
    ptxas log)]}."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    procs = []
    for name in sweeps:
        srcs = [str(_build.CSRC / SWEEP_SOURCES[name]), str(_build.CSRC / "remap_gather.cu")]
        for i, cfg in enumerate(SWEEPS[name][1:], 1):
            lib = _build.BUILD_DIR / f"{name}_variant{i}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS,
                   *(f"-D{k}={v}" for k, v in cfg.items()), "-o", str(lib), *srcs]
            procs.append((name, cfg, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {name: [] for name in sweeps}
    for name, cfg, lib, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name} {_label(cfg)}:\n{log}")
        built[name].append((cfg, lib, log))
    return built


def _bind(path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.blinky_error_string.argtypes = [ctypes.c_int]
    lib.blinky_error_string.restype = ctypes.c_char_p
    return lib


def rotate_rays_launch_ms(lib, vx, vy, vz, bases, iters=20):
    """K13's ms a launch in *lib*: CUDA events around *iters* back-to-back
    launches of ``blinky_rotate_rays`` into outputs made once, so that the
    wrapper's host time (tens of microseconds) does not hide a short launch.
    ``bases`` [B, 3, 3], or None for the unrotated mode on [steps, ...]
    tables; arguments as :func:`blinky_tpu_torch.lensmap.builder.rotate_rays`
    takes them.  Returns (ms, the outputs of the last launch)."""
    from blinky_tpu_torch.bench.sol import cuda_ms

    dev = vx.device
    batch = int(bases.shape[0]) if bases is not None else int(vx.shape[0])
    shape = ((batch,) if bases is not None else ()) + tuple(vx.shape)
    npix = vx.numel() // (1 if bases is not None else batch)
    with _build.on_device(dev) as stream:
        out = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3)]
        args = (vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), npix, _build.ptr(bases), batch,
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream)

        def launch():
            _build.check(lib.blinky_rotate_rays(*args), "rotate_rays")

        return cuda_ms(launch, iters), tuple(out)


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
    holds a CALL, first opcodes, nested in another region)."""
    back = [(a, int(m.group(1), 16)) for a, t in ins
            for m in [re.search(r"BRA (0x[0-9a-f]+)", t)] if m and int(m.group(1), 16) < a]
    end, head = max(back, key=lambda e: e[0] - e[1])
    body = [(a, t) for a, t in ins if head <= a <= end]
    spans = []
    for a, t in body:
        m = re.search(r"@!?U?P\d BRA (0x[0-9a-f]+)", t)
        if m and a < int(m.group(1), 16) <= end:
            spans.append((a, int(m.group(1), 16)))
    regions = []
    for a, b in spans:
        skipped = [x for c, x in body if a < c < b]
        nested = any(a2 < a and b <= b2 for a2, b2 in spans)
        regions.append((len(skipped), any("CALL" in x for x in skipped),
                        " ".join(x.split()[0] for x in skipped[:6]), nested))
    return len(body), regions


def main_path(n, regions):
    """The loop's instructions on the main path (every pixel valid, a u8
    source that is not expanded): the loop less the regions that hold a
    CALL (the IEEE sequences' slow paths) and the regions nested in a branch
    the main path takes (the expanded source's grid test inside a valid
    pixel's index, the background read inside the first-hole test)."""
    return n - sum(size for size, call, _, nested in regions if call or nested)


def compare_sass(funcs, other):
    """Functions of two builds' SASS ({name: [(address, instruction)]})
    -> (names whose instructions are the same, names whose instructions
    differ, names in *funcs* only, names in *other* only).  Names are taken
    without the hash nvcc gives each build's anonymous namespace."""
    def bare(fs):
        return {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", n): ins for n, ins in fs.items()}

    funcs, other = bare(funcs), bare(other)
    same = sorted(n for n in funcs if n in other
                  and [t for _, t in funcs[n]] == [t for _, t in other[n]])
    differ = sorted(n for n in funcs if n in other and n not in same)
    return same, differ, sorted(set(funcs) - set(other)), sorted(set(other) - set(funcs))


def _timed(variants, run, what, say):
    """Each variant's ms, in turns forwards and backwards, its output held
    bit-equal to the package's build (NaN equal to NaN); *variants*
    [(label, library)], the package's build first; ``run(library)`` returns
    (ms, output tensor or tuple of them).  Returns {label: ms}."""
    def same(a, b):
        a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
        return all(torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            x.nan_to_num(7.0), y.nan_to_num(7.0)) and torch.equal(x.isnan(), y.isnan()))
            for x, y in zip(a, b))

    ref = run(variants[0][1])[1]
    times = {label: [] for label, _ in variants}
    for order in (variants, variants[::-1]):
        for label, lib in order:
            ms, got = run(lib)
            if not same(got, ref):
                raise SystemExit(f"{what}: {label} differs from the package's build")
            times[label].append(ms)
            del got
    out = {label: float(np.mean(ts)) for label, ts in times.items()}
    for label, ms in out.items():
        say(f"{what}: {label}: {ms:.4f} ms; bit-equal")
    return out


def _wrapper_run(call, iters):
    """run(library) for :func:`_timed`: the wrapper's output and its ms by
    CUDA events, with *library* standing in for the package's build."""
    from blinky_tpu_torch.bench.sol import cuda_ms

    def run(lib):
        home = _build._lib
        _build._lib = lib
        try:
            return cuda_ms(call, iters), call()
        finally:
            _build._lib = home

    return run


def _sass_loop(sass, key, what, out_dir, say):
    """Counts the pose-group loop of the SASS function whose name holds *key*;
    returns (loop instructions, main-path instructions)."""
    for name, ins in sass_functions(sass).items():
        if key not in name:
            continue
        (out_dir / f"k6_u8_k1_{what}.sass").write_text(
            "\n".join(f"{a:04x} {t}" for a, t in ins) + "\n")
        n, regions = loop_count(ins)
        main = main_path(n, regions)
        say(f"SASS of K6 u8 k=1 {what} ({name}): {len(ins)} instructions, the pose-group "
            f"loop {n}, {main} on the main path; the regions its forward branches jump "
            "over:")
        for size, call, first, nested in regions:
            say(f"  {size} instructions{' (holds a CALL)' if call else ''}"
                f"{' (nested)' if nested else ''}: {first} ...")
        return n, main
    raise SystemExit(f"no SASS function holds {key}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/posed_sweep")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--what", default="all", choices=["all", "sass", *SWEEPS])
    ap.add_argument("--against", default=None,
                    help="another build of the kernel library to compare the SASS with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("posed sweep: no CUDA device", file=sys.stderr)
        return 1
    import tempfile

    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import lua_drop_ins
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
    from blinky_tpu_torch.kernels import posed, static_ray
    from blinky_tpu_torch.palette import MAX_PLATES, rgba_lut

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    say(f"card: {smi.strip()}")
    sweeps = list(SWEEPS) if args.what == "all" else [] if args.what == "sass" else [args.what]
    home = _build.library()
    t0 = time.perf_counter()
    built = _build_variants(sweeps)
    say(f"{sum(map(len, built.values()))} builds in {time.perf_counter() - t0:.1f} s")
    variants = {}
    for name, vs in built.items():
        variants[name] = [("the source's defaults", home)]
        for i, (cfg, lib, log) in enumerate(vs, 1):
            (out_dir / f"{name}_variant{i}.ptxas.txt").write_text(log)
            regs = sorted({int(m) for m in re.findall(r"Used (\d+) registers", log)})
            say(f"  {name} variant {i} ({_label(cfg)}): registers {regs}, "
                f"spills {'none' if ' 0 bytes spill stores' in log else 'SOME'}")
            variants[name].append((_label(cfg), _bind(lib)))

    dev = torch.device("cuda")
    B, S = 64, 1080
    frames = torch.from_numpy(synthetic_cubemap_batch(S, B)).to(dev)
    poses = posed_poses(B)
    bases_np = posed.bases_from_pose_track(poses)
    if "maxdot" in sweeps:
        sess = Session(1920, 1080, device=dev)
        for k in (1, 2):
            sess.render_posed(frames, poses, render_scale=k)
            kern = sess._posed_cache[1]
            src, bases, expanded = posed.prep_posed_inputs(frames, bases_np, S,
                                                           kern.background, dev)
            _timed(variants["maxdot"], _wrapper_run(
                lambda: static_ray.static_ray_posed(  # noqa: B023
                    src, kern.ray_table, bases, kern.globe, S, kern.numcells,
                    kern.cell_size, kern.pad_size, expanded, kern.background, k), args.iters),
                f"K6 cube (mode 3) u8 1080p B={B} k={k}", say)
            del src
    if "given" in sweeps or "k13" in sweeps:
        tmp = tempfile.mkdtemp(prefix="blinky_lua_")
        sess = Session(1920, 1080, device=dev, globe_dirs=[lua_drop_ins.write_scripts(tmp)])
        sess.cmd("f_globe lfast")
        lut = torch.from_numpy(rgba_lut(sess.palette).view(np.int32)).to(dev)
        for k in (1, 2):
            sess.render_posed(frames, poses, render_scale=k)
            kern = sess._posed_cache[1]
            table = kern.ray_table
            src, bases, expanded = posed.prep_posed_inputs(frames, bases_np, S,
                                                           kern.background, dev)
            if "given" in sweeps:
                plates = static_ray.script_pose_plates(table, bases, kern.globe)
                kinds = [("u8", src, kern.background)]
                if k == 1:
                    kinds.append(("RGBA", posed.posed_layout(lut[frames.long()], MAX_PLATES),
                                  lut[kern.background.long()]))
                for kind, sk, bg in kinds:
                    _timed(variants["given"], _wrapper_run(
                        lambda: static_ray.static_ray_posed(  # noqa: B023
                            sk, table, bases, kern.globe, S, kern.numcells, kern.cell_size,
                            kern.pad_size, expanded, bg, k, plates=plates), args.iters),
                        f"K6 mode 2 (lfast) {kind} 1080p B={B} k={k}", say)
                del plates, kinds
            if "k13" in sweeps and k == 1:
                steps = [torch.stack([c * (1 + 0.1 * n) for n in range(8)])
                         for c in (table.vx, table.vy, table.vz)]
                cases = (("B=64", (table.vx, table.vy, table.vz, bases)),
                         ("one pose (the build's call)", (table.vx, table.vy, table.vz,
                                                          bases[:1].contiguous())),
                         ("8 unrotated steps (a sweep chunk)", (*steps, None)))
                for what, a in cases:
                    _timed(variants["k13"],
                           lambda lib: rotate_rays_launch_ms(lib, *a, args.iters),  # noqa: B023
                           f"K13 at 1080p, {what}, by launches of its entry point", say)
                del steps
            del src
            torch.cuda.empty_cache()

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"

    def disassemble(lib):
        return subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout

    sass = disassemble(_build.LIBRARY)
    # the issue floor: 128 lane-instructions a clock on every SM at the
    # card's highest SM clock, over the main path's instructions for 1080p,
    # B = 64 (four build pixels a loop iteration)
    mhz = float(smi.split(",")[2].split()[0])
    lanes_per_s = 128 * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6
    pose_pixels = B * 1920 * 1080
    for what, key in (("maxdot", "static_ray_posed_kernelIhLi1ELi0E"),
                      ("given", "static_ray_posed_kernelIhLi1ELi2E"),
                      ("cube", "static_ray_posed_kernelIhLi1ELi3E")):
        n, main = _sass_loop(sass, key, what, out_dir, say)
        floor = main / 4 * pose_pixels / lanes_per_s * 1e3
        say(f"K6 u8 k=1 {what}: the pose-group loop {n} SASS instructions for one pose and "
            f"four build pixels, {main} on the main path, {main / 4:.2f} a pose-pixel; issue "
            f"floor at 1080p B={B} {floor:.4f} ms ({mhz:.0f} MHz)")
    funcs = sass_functions(sass)
    for name, ins in sorted(funcs.items()):
        if "lensmap_resolve_kernel" in name or "sweep_remap_kernel" in name:
            say(f"SASS of {'K8' if 'lensmap' in name else 'K9'} {name}: {len(ins)} instructions")
    if args.against:
        same, differ, here, there = compare_sass(funcs, sass_functions(disassemble(args.against)))
        say(f"SASS against {args.against}: {len(same)} functions the same instruction for "
            f"instruction, {len(differ)} differ, {len(here)} only in this build, {len(there)} "
            "only in the other")
        for label, names in (("differs", differ), ("only in this build", here),
                             ("only in the other", there)):
            for name in names:
                say(f"  {label}: {name} ({len(funcs.get(name, []))} instructions here)")
    (out_dir / "posed_bench.txt").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
