"""Smoke run of the PyTorch/CUDA port (blinky_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the smoke run, on one card
    python3 chip_smoke.py --sweep      # K5's, K7's and K10's tuning constants
    python3 chip_smoke.py --sweep k10  # K10's ring alone

Builds the hand-written CUDA kernels from ``blinky_tpu_torch/csrc`` and drives
the port's main paths at 1920x1080 (panini + cube, ``f_fov 180``):
``Session.render``, ``Session.render_posed`` and the float32 device builder's
(``Session(backend="torch")``, ``setviewangles``, ``PosedRemapKernel``,
``zoom_sweep_remap``), the 360-video path at 4096x2048 panos -> 1280x720
(``Session.render_equirect``, ``Session.render_aa``), the twelve lenses
that ride the forward rasterizer and the float32 builder, and the recorded
path from files through ``timedemo`` back to files; then checks and
times every kernel against its plain PyTorch version.  Phases:

1. set-up: the card's name and power limit, the kernel build, and the
   native host library removed, rebuilt and timed (the run fails if it
   does not load, so no phase measures the NumPy fallbacks);
2. main path: with every launch counter at 0, the Session renders a
   64-frame 1080p batch plain (K1), with ``f_rubix`` and with RGB decode
   (K2), and the speed-of-light probe entry point runs (K3, K4); the counters
   are read, and the renders are held against the plain versions on the card,
   against ``host_remap`` for frames 0 and 63, and against the golden screens
   of ``tests/goldens/panini__cube__fov180.npz``.  Then every K1 and K2
   variant at 1080p B=64 (K1 on u8, on true-colour u32 with the tint, on the
   12-plane expanded rubix source; K2 rubix, decode, rubix + decode and the
   expanded decode, and rubix on a uniformly random and on an all-zero
   source) is held bit-equal to its plain version and timed beside it, with
   its bytes, its bound at 3.35 TB/s and its share of that bound;
3. every source kind through ``RemapKernel``, and out-of-range indices under
   the clip and the fill rule, against the plain versions;
4. the headline shape: a texel-compacted 1080p source at B = 1024 and 4096,
   K1 held to its plain version over the whole batch and timed beside it;
5. the probes' results: K3 at 64x384x2048x1024 (the JAX probe's source
   values below 128, and every u8 value), its extrapolation to a 1080p
   screen beside K1's 1080p time, K4 over 1 GiB, and the card's int8 and
   bf16 matrix-product rates at the one-hot gather's shapes, K3's yardstick;
   the library call beside K3 (``torch.gather``) and K4 (``x.sum``); and the
   plain torch yardsticks: the copy rate over 1 GiB, the row gather of a
   1080p screen's indices at 1024 and 128 lanes, the element gather;
6. the posed path: with every launch counter at 0, ``Session.render_posed``
   renders 64 seeded poses of the 1080p batch (K6) for the u8, the expanded
   12-plane rubix and the RGBA u32 source at render_scale 1 and 2, and two
   poses with ``exact=True`` (K5), each call laying its frames out
   pose-major through K7; the counters are read.  Each screen is
   held bit-equal to ``static_ray_posed_plain`` on the card (8 poses at a
   time), the exact screens to ``host_remap`` of the exact host build at each
   pose, the identity pose near the static render; ``render_scale="auto"``
   at 60 fps.  Then K5 alone on the plain version's indices, for the u8,
   expanded and RGBA source at render scales 1 and 2 at B=64, each
   bit-checked and timed beside its plain version and its byte bound; K6 on
   every variant at B=64 and B=1 beside its plain version, with its bytes,
   float32 operations and bound, its device time from ``torch.profiler``'s
   kernel records and the wrapper's host time a call; the ray-table build;
   K7 on every source at B=64 and on a one-pose slice, and on u8 and RGBA as
   contiguous ragged batches (B = 63, 2, 8) and a chunk slice ``[..., 0:40]``,
   each bit-equal to ``permute().contiguous()`` and its plain version and
   timed beside both, with its byte bound and, for a slice, its sector
   floor; the one-pose view that launches nothing; K7 on rows of 1 KB (u8
   B = 1024, the posed cell's frames, and RGBA B = 256), every launch
   counted on its long-row path; and ``render_posed``'s wall
   clock at B=64 and B=1, split into the pose bases, K7, K6 and the rest,
   with the device's idle share, from profiler runs of the call given the
   poses and given their bases;
7. the float32 device builder: with every launch counter at 0, a
   ``Session(backend="torch")`` renders the 64-frame batch (the lens stage,
   K8, K1), a default Session renders it after ``setviewangles 10 30 0``,
   ``PosedRemapKernel`` renders the 64 poses for the u8 and the expanded
   source at render scales 1 and 2 (the lens stage, K7, K6), and
   ``zoom_sweep_remap`` renders the 24-step ``f_fov`` 100-330 ramp of one
   frame, u8 and expanded (the lens stage, K9); the counters are read.  K8 is
   held bit-equal to ``rays_to_lensmap_torch`` on the same rays (the cube and
   the fast globe, the identity and two rotated bases), the build to the
   exact host build within the float32 boundary tolerance, the renders to
   their plain versions and ``host_remap``, the fused posed screens to
   ``static_ray_posed_plain`` and ``StaticRayPosedKernel``, K9 to its plain
   version step by step and to the per-step loop of
   ``Session(backend="torch")``.  Then the warm rebuild is timed, split into
   the lens stage and K8, beside the exact host build and the first call; a
   rebuild to the first frame; K9 beside its bound and the sweep beside its
   loop; the builds of mollweide, winkeltripel and fisheye1; and the lens
   stage's peak of live memory beside what the sweep's chunking allows;
8. the 360-video path: with every launch counter at 0, a
   ``Session(1280, 720, platesize=720)`` renders a 128-lane batch of
   4096x2048 panos made on the card (4 GiB) through ``render_equirect`` in
   the modes compact, fused and faces, plain and with ``f_rubix``, bilinear
   and nearest (K10, and K1 for compact and faces); a 1080p Session renders
   the 64-frame batch through ``render_aa`` at factor 2 (K1 at 3840x2160,
   then K11), and the 720p Session a rubix ``render_aa`` of the faces'
   expansion on the card (K12); the counters are read, K10's ring launches
   among them (every launch of the path: its rows are 512 bytes).  The three modes are
   held bit-equal to each other, to ``equirect_gather_plain`` and the plain
   remap on the card (16 lanes at a time), and lanes 0 and 127 to the
   all-host path (``EquirectIngest.host``, ``host_remap``); K11 and K12 to
   their plain versions; ``render_aa(factor=1)`` to the plain u32 render.
   Then every K10 variant (the full faces, the compact subset, the fused
   screen with and without the tint; bilinear and nearest), K11 and K12 are
   timed beside their plain versions with their bytes, bound and share of
   it, each K10 variant's ring in turns with its register path,
   K10-nearest beside ``torch.index_select``; the three modes end to end
   with the panos on the card, in panos a second
   (``bench.throughput.run_equirect_throughput``), and once from a NumPy
   batch; the compact mode at B = 1, 16 and 128; and ``render_aa``, split by
   ``torch.profiler``'s records into the palette decode, K1 and K11, with
   K1's byte bound at 3840x2160;
9. the last twelve lenses (quincuncial, debug and the ten forward-only
   projections): with every launch counter at 0, a 1080p Session renders the
   64-frame batch through each of the twelve at its ``onload`` zoom after an
   exact host build (the forward rasterizer with the native quad fill for
   the ten), eckert1 with ``f_rubix`` and ``decode_rgb`` (K2), eckert1's
   ``render_posed`` of the 64 poses at render scales 1 and 2 on the
   rasterized lensmap's ray table (K7, K6) and two exact poses (K5), eckert1
   after ``setviewangles 10 30 0`` (the rasterizer with the view basis, K1),
   quincuncial and debug on ``Session(backend="torch")`` (the lens stage,
   K8, K1), and eckert1's ``render_equirect`` of phase 8's panos in the
   compact and the fused mode (K10); the counters are read and printed.  Each
   output is held bit-equal to its plain version on the card and to
   ``host_remap`` (of the per-pose rasterizations for the exact poses, of an
   independent rasterization for the rotated view), the equirect modes to
   each other and lanes 0 and 127 to the all-host path; each host build's
   seconds, valid share and plates used, the identity pose's share off the
   static render, and quincuncial's and debug's lens stage and K8 times and
   float32 share off the exact build are printed.

10. the Lua drop-ins (``blinky_tpu_torch/bench/lua_drop_ins.py``, written to
   a temporary directory for ``lens_dirs`` and ``globe_dirs``): with every
   launch counter at 0, ``lpanini.lua`` renders the batch on
   ``Session(backend="torch")`` (the Lua lens stage on the card, K8, K1),
   after ``setviewangles 10 30 0`` and through ``render_posed`` of the 64
   poses at k = 1 and 2 (K7, K6); ``lnewton.lua`` (a data-dependent
   ``repeat ... until``: the tensor mode's masked loop) on
   ``Session(backend="torch")``; the ``lfast.lua`` globe on
   ``Session(backend="torch")`` (K13, the rotate pre-pass, the script
   resolver on the card, K8 in resolver mode 2, K1), through
   ``render_posed`` of the 64 poses (K13, K6 in mode 2) and an 8-step
   ``zoom_sweep_remap`` (K13 unrotated, K9 in mode 2); and ``scat.lua``, a
   scalar-only lens, on the exact host route (its host build, K1,
   ``render_posed`` at k=2 through a host ray table, one exact pose, K5);
   the counters are read.  lpanini's screens are held bit-equal to the
   built-in panini's on the card; K8, K6 and K9 in mode 2 and K13 bit-equal
   to their plain versions on the same rays and plates; lfast's tables and
   screens beside the built-in fast globe's; each Lua lens stage's time
   beside the built-in's, the resolver's over the posed batch, and the
   mode-2 kernels and K13 beside their bounds.  lfast's posed plates (K14,
   its resolver recorded as a tape) are held byte-equal to the evaluator's
   pose by pose, and K14 on one piece of ``lfast.posed_card``'s call (as
   many of its 1024 poses as the stage's plan takes) to the evaluator and
   to the tape's replay, timed beside both and its 13-byte-a-ray bound.
11. the rest of the Session surface: with every launch counter at 0, a 1080p
   Session renders the batch under ``fisheye 0`` at ``fov 90`` and 110, plain
   (K1) and with ``decode_rgb`` (K2), then after ``setviewangles 10 30 0``
   (the plain table on the float32 builder: the lens stage, K8, K1); phase
   8's 720p Session renders its panos through ``render_equirect`` compact
   under ``fisheye 0`` (the faces, K10, then the plain view, K1); a 1080p
   ``render_aa`` at factor 2 under ``fisheye 0`` (K1 at 3840x2160, K11); a
   ``Session(1920, 1080, build_budget_s=1/60)`` with its float32 builder warm
   switches to stereographic and renders until the exact build lands (the
   float32 preview first: the lens stage, K8, K1), and another with a cold
   builder switches to hammer (the partial table's preview, a new
   RemapKernel each render); ``f_saveglobe`` through ``render`` and
   ``render_equirect``; a console session runs ``f_shortcutkeys``,
   ``press_key``, ``bind`` / ``unbind`` and ``stuffcmds`` of its command
   line, and its config is exec'd into a fresh Session; the counters are read
   and printed.  The plain views are held bit-equal to their plain versions
   and ``host_remap`` for frames 0 and 63, K8 to ``rays_to_lensmap_torch``,
   the equirect lanes 0 and 127 to the all-host path, ``render_aa`` to its
   plain versions, the time-sliced build's final screens to a blocking
   build's, every partial render to the background on its unbuilt rows and
   to ``host_remap`` of its table, the PCX files to ``save_globe_pcx`` of
   the host's frame 0 (of the faces' lane 0, low byte), and the replayed
   config's screens to the console session's; K1's time on the plain table
   beside its byte bound, the plain table's host build, the preview's
   first-frame latency beside the blocking build, the renders and the
   largest render call until the swap, and the partial preview's render
   with its table upload are printed.
12. recorded inputs and outputs, in a temporary directory that it removes:
   96 rolled 1080p cubemaps written as ``f_saveglobe`` PCX dumps (576
   plates), a ``.dem`` of 24 messages, 8 frames of true-colour PNG faces at
   S = 1080, four 4096x2048 PNG panoramas and a PAK holding
   ``gfx/palette.lmp``.  With every launch counter at 0, the saveglobe dumps
   are imported, the ``.dem`` track is read and resampled by
   ``lerp_pose_track`` to 96 poses, both go into a demo container and back,
   ``timedemo`` replays the 96 frames on ``Session(1920, 1080)`` at B = 64
   (one full batch, one padded to ``n_valid = 32``) plain (K1), with
   ``f_rubix`` and with ``decode_rgb`` (K2), the 96 screens are rendered,
   the first batch goes through ``render_posed`` on its 64 ``.dem`` poses
   (K7, K6), the PNG faces are imported and rendered as u32 frames (K1), the
   panoramas are imported at S = 720 (``EquirectIngest.host``), and the
   PAK's palette drives a ``decode_rgb`` render (K2); the counters are read.
   The imports are held equal to what was written, every last batch's valid
   frames and padded lanes to ``host_remap``, the posed screens to
   ``static_ray_posed_plain`` on the card, the equirect import to
   ``EquirectIngest`` (K10) on the card; 8 ``decode_rgb`` screens go through
   the PNG codec, the 96 u8 screens through the GIF codec, both round trips
   exact, and 8 u32 screens through ``encode_gif_u32``.  The codecs' seconds
   a frame, the import's seconds a pano beside K10's ms, and each replay's
   frames/s split into the iterator's pack, the copy to the card and K1/K2
   by their profiler records are printed, and one more call of each replay
   cut into spans on one clock (``timedemo_spans``).

13. (run right after phase 1, while this process holds nothing on the card)
   the bench suite's entry point, each run in a process of its own
   (``python -m blinky_tpu_torch.bench``, launch counts gathered through
   ``BLINKY_BENCH_LAUNCHES``): the headline, whose batch must be the
   planner's derivation for this card, with its frames/s, ms a batch, GB/s
   and K1's share of its byte bound; ``--all --quick``, whose eight configs
   must each be there with every gated key measured and every ``exact``
   True, and which exits non-zero if any of its measurements finds a kernel
   (K1, K2, K5-K8, K10) differing from its plain version on that
   measurement's inputs, as each holds them before it times them
   (``throughput.checked``); ``--sol`` (K3, K4); ``--check --configs 0-3`` against the
   committed H100 baseline, whose verdict is printed (exit 0 or 1: a speed
   gate, not a correctness check); and two calibrate probes, one at
   B = 128 that must run and one past the card's memory that must be
   classified as out of memory.

14. the mesh, the CLI and the viewer: the sharded functions
   (``blinky_tpu_torch.parallel``) at 1080p B = 64 on a logical (4, 2) mesh of
   the card, a two-level (2, 2, 2) one and the mesh of the cards there are,
   each bit-equal to its unsharded path (``remap_sharded`` on u8, f_rubix,
   decode_rgb, expanded and RGBA sources, ``build_lensmap_sharded``, the two
   posed sharded functions, the two equirect ones at 4096x2048 -> S = 720 ->
   1280x720 B = 128, ``Session.render_sharded``); the split's cost against
   the unsharded render; both weak scalings; ``python -m
   blinky_tpu_torch.cli`` in eleven processes at once, each output held to the
   same command on the CPU (byte-equal, the float32 lens stage's two within
   ``FLOAT_STAGE``), and one 1080p ``reproject`` timed; ``cli serve`` in a
   process of its own to ``device_ready``; and the viewer in this process:
   its start to ``device_ready``, ``/frame.png`` byte-equal to the CPU
   session's screen, a drag-look, a lens key and ``/record.gif``.

15. (run right after phase 7) globes that no shipped layout has
   (``bench/fuzz_globes.py``): with every launch counter at 0, four seeded
   random globes of 1, 2, 4 and 6 plates and the tie layout (two plates on
   one forward beside a third), each a Python globe module loaded by
   ``f_globe`` from the Session's ``globe_dirs``, under a random
   ``f_rubixgrid``: the exact host lensmap, then a random ``[6, 1080, 1080,
   64]`` u8 batch rendered plain (K1), with ``f_rubix`` and with
   ``decode_rgb`` (K2); ``build_lensmap(backend="torch")`` (the lens stage,
   K8 in max-dot mode); ``render_posed`` of 16 poses at k = 1 on the 1- and
   6-plate globes (K7, K6); ``zoom_sweep_remap`` of an 8-step ramp on the
   2-plate globe (K9); the counters are read.  Each screen is held bit-equal
   to its plain version on the card and frames 0 and 63 to ``host_remap``,
   K8 to its plain version on the same rays, the float32 build to the exact
   one within the boundary tolerance (its share printed), the posed screens
   to ``static_ray_posed_plain`` and the sweep to its plain version step by
   step.  Then each kernel's time on each globe by its kernel record, beside
   the main path's row.

The line before the card's name and power limit lists every kernel with its
launches in its path's run (phase 2 for K1-K4, phase 6 for K5-K7, phase 7
for K8 and K9, phase 8 for K10-K12, phase 10 for the mode-2 kernels, K13
and K14; phase 12's launches of K1, K2, K6 and K7, phase 15's of K1, K2 and
K6-K9, and phase 13's and 14's are added to theirs), its
time, its plain version's and its library call's time where one PyTorch call
computes the same function, and its bound.

Catches nothing: any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 at once.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
B_MAIN = 64
ITERS = 10
# an H100 SXM's published device-memory rate at 700 W
HBM_BYTES_PER_S = 3.35e12
# its float32 operations a second outside the tensor cores, one a lane and
# clock (67 TFLOP/s counts a fused multiply-add as two); NVIDIA's H100 SXM
# data sheet
F32_OPS_PER_S = 33.5e12


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def main():
    script_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a GPU",
              file=sys.stderr)
        return 1

    from blinky_tpu_torch import native
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import sol
    from blinky_tpu_torch.bench.__main__ import kernel_wrappers
    from blinky_tpu_torch.bench.throughput import run_gather_throughput
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap, synthetic_cubemap_batch
    from blinky_tpu_torch.kernels import _build, remap
    from blinky_tpu_torch.palette import rgba_lut

    dev = torch.device("cuda")
    # the main path's kernels (phase 2), by the names of the one mapping from
    # kernel names to wrappers, which phase 13's launch counts use too
    wrappers = kernel_wrappers()
    kernels = {name: wrappers[name]
               for name in ("remap_gather", "remap_lut", "onehot_gather", "stream_read")}

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    phase(1, f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    nvcc_s = _build.last_build["seconds"] if _build.last_build else None
    phase(1, f"kernels built and loaded in {build_s:.3f} s (nvcc {nvcc_s} s) "
          f"from {[str(p.relative_to(ROOT)) for p in _build.sources()]}")
    if _build.last_build:
        for line in _build.last_build["log"].splitlines():
            # registers, shared memory, spills, and any wgmma serialisation note
            if any(k in line for k in ("Used", "spill", "Compiling entry", "C75")):
                print("  ptxas:", line.strip().removeprefix("ptxas info    :").strip())
    # the port's native host library, built anew from its source and timed:
    # every later phase runs its host paths (palmap, the libm loops, the
    # forward quad fill, the codecs, pack_batch) and never their NumPy fallbacks
    had = native.LIBRARY.exists()
    native.LIBRARY.unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = native.build_library()
    native_s = time.perf_counter() - t0
    require(built and native.available(), "the port's native library did not build")
    phase(1, f"native library {native.LIBRARY.relative_to(ROOT)} built from "
          f"{native.SOURCE.relative_to(ROOT)} in {native_s:.3f} s "
          f"({'a copy already present was removed first' if had else 'none was present'}; "
          f"{' '.join([os.environ.get('CXX', 'g++'), *native.CXXFLAGS])}) and loaded")

    # phase 13, the bench's entry point, runs here, while this process holds
    # nothing on the card: its processes fill the card's memory
    bench_launches = bench_phase(dev)

    # ---------------------------------------------------------------- 2
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sess = Session(1920, 1080, device=dev)
    lm = sess.lensmap
    lensmap_s = time.perf_counter() - t0
    phase(2, f"Session(1920, 1080): {sess.lens_name} + {sess.globe_name}, "
          f"{sess.zoom.command()}; exact host lensmap in {lensmap_s:.3f} s, "
          f"valid.sum() = {int(lm.valid.sum())}")
    frames = synthetic_cubemap_batch(1080, B_MAIN)
    frames_dev = torch.from_numpy(frames).to(dev)
    out = sess.render(frames_dev)
    sess.cmd("f_rubix")
    out_rubix = sess.render(frames_dev)
    sess.cmd("f_rubix")
    out_rgb = sess.render(frames_dev, decode_rgb=True)
    probes = sol.run_sol(dev)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    phase(2, f"launches in the main path's run: {launches}")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the main path")

    k = remap.RemapKernel(lm, sess.palette, device=dev)  # the render's operands
    src = frames_dev.reshape(-1, B_MAIN)
    require(out.shape == (1080, 1920, B_MAIN) and out.dtype == torch.uint8,
            f"render gave {tuple(out.shape)} {out.dtype}")
    plain = remap.remap_gather_plain(src, k.flat_idx, k.valid, k.background,
                                     fill=True).reshape(out.shape)
    plain_rubix = remap.remap_lut_plain(src, k.flat_idx, k.valid, k.tint,
                                        k.background, k.tint_lut).reshape(out.shape)
    plain_rgb = remap.remap_lut_plain(src, k.flat_idx, k.valid, k.tint, k.background,
                                      None, k.rgb_lut).reshape(out_rgb.shape)
    err = {}
    for name, got, ref in (("render", out, plain), ("render f_rubix", out_rubix, plain_rubix),
                           ("render decode_rgb", out_rgb, plain_rgb)):
        e = int((got.int() - ref.int()).abs().max())
        require(torch.equal(got, ref), f"{name} differs from the plain version (max {e})")
        err[name] = e
    for b in (0, B_MAIN - 1):
        f = frames[..., b]
        for name, got, kw in (("render", out, {}), ("render f_rubix", out_rubix,
                                                    dict(rubix=True)),
                              ("render decode_rgb", out_rgb, dict(decode_rgb=True))):
            host = sess.render_host(f, **kw)
            dev_b = got[..., b, :] if kw.get("decode_rgb") else got[..., b]
            require(np.array_equal(dev_b.cpu().numpy(), host),
                    f"{name} frame {b} differs from host_remap")
    phase(2, "render, f_rubix render and decode_rgb render bit-equal their plain "
          "versions on the card and host_remap for frames 0 and 63")
    golden = np.load(ROOT / "tests" / "goldens" / "panini__cube__fov180.npz")
    small = Session(64, 48, device=dev)
    small_frames = synthetic_cubemap(48)
    require(np.array_equal(small.render(small_frames).cpu().numpy(), golden["screen"]),
            "64x48 screen differs from the golden")
    small_rubix = small.render(
        remap.expand_frames_tinted(small_frames, small.palette), rubix=True)
    require(np.array_equal(small_rubix.cpu().numpy(), golden["rubix"]),
            "64x48 rubix screen differs from the golden")
    phase(2, "64x48 screen and rubix screen equal tests/goldens/panini__cube__fov180.npz")

    # Every K1 and K2 variant at 1080p B=64, each first held bit-equal to its
    # plain version on these inputs, then timed beside it against its bound:
    # the bytes it must move (per-pixel operands, the source rows that this
    # lensmap reads, the output) at the card's 3.35 TB/s.
    n = k.flat_idx.numel()
    tr, tm = k.tint_rgb_mask
    src32 = torch.from_numpy(rgba_lut(sess.palette).view(np.int32)).to(dev)[src.long()]
    expanded = torch.from_numpy(remap.expand_frames_tinted(frames, sess.palette)).to(dev)
    expanded = expanded.reshape(-1, B_MAIN)
    noise = torch.randint(0, 256, src.shape, dtype=torch.uint8, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
    zeros = torch.zeros_like(src)
    gather_args = {  # K1: (src, idx, bg, keywords)
        "K1 u8 (render)": (src, k.flat_idx, k.background, dict(fill=True)),
        "K1 true-colour tint (u32)": (src32, k.flat_idx, k.background_rgba,
                                      dict(tint_rgb=tr, tint_mask=tm)),
        "K1 expanded 12-plane rubix (clip)": (expanded, k.flat_idx_rubix, k.background, {}),
    }
    lut_args = {  # K2: (src, idx, tint_lut, rgb_lut, fill)
        "K2 rubix (render f_rubix)": (src, k.flat_idx, k.tint_lut, None, True),
        "K2 rubix, uniformly random source": (noise, k.flat_idx, k.tint_lut, None, True),
        "K2 rubix, all-zero source": (zeros, k.flat_idx, k.tint_lut, None, True),
        "K2 decode (render decode_rgb)": (src, k.flat_idx, None, k.rgb_lut, True),
        "K2 rubix + decode": (src, k.flat_idx, k.tint_lut, k.rgb_lut, True),
        "K2 expanded decode (clip)": (expanded, k.flat_idx_rubix, None, k.rgb_lut, False),
    }
    variants = {}
    for name, (s_, idx, bg, kw) in gather_args.items():
        run = (lambda s_=s_, idx=idx, bg=bg, kw=kw:
               remap.remap_gather(s_, idx, k.valid, bg, **kw))
        ref = (lambda s_=s_, idx=idx, bg=bg, kw=kw:
               remap.remap_gather_plain(s_, idx, k.valid, bg, **kw))
        per_pixel = 4 + 1 + s_.element_size() + (5 if "tint_rgb" in kw else 0)
        rows = source_rows(idx, k.valid, s_.shape[0], kw.get("fill", False))
        nbytes = n * per_pixel + (rows + n) * B_MAIN * s_.element_size()
        variants[name] = time_variant(name, run, ref, nbytes)
    for name, (s_, idx, tl, rgb, fill) in lut_args.items():
        run = (lambda s_=s_, idx=idx, tl=tl, rgb=rgb, fill=fill:
               remap.remap_lut(s_, idx, k.valid, k.tint, k.background, tl, rgb, fill=fill))
        ref = (lambda s_=s_, idx=idx, tl=tl, rgb=rgb, fill=fill:
               remap.remap_lut_plain(s_, idx, k.valid, k.tint, k.background, tl, rgb,
                                     fill=fill))
        per_pixel = 4 + 1 + 1 + (1 if tl is not None else 0)
        tables = (tl.numel() if tl is not None else 0) + (rgb.numel() if rgb is not None else 0)
        rows = source_rows(idx, k.valid, s_.shape[0], fill)
        nbytes = (n * per_pixel + tables + rows * B_MAIN
                  + n * B_MAIN * (3 if rgb is not None else 1))
        variants[name] = time_variant(name, run, ref, nbytes)
    del src32, expanded, noise, zeros
    phase(2, f"K1's ring path (rows of {remap.RING_MIN_ROW_BYTES} bytes and more, "
          f"remap.ring_path) took {remap.remap_gather.bulk_launches} of K1's "
          f"{remap.remap_gather.launches} launches so far")
    main_ms = {"remap_gather": variants["K1 u8 (render)"],
               "remap_lut": variants["K2 rubix (render f_rubix)"]}
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sess.render(frames)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    phase(2, f"Session.render of the NumPy batch ({frames.nbytes} bytes copied to the "
          f"card, then K1), host wall clock: {', '.join(f'{w:.3f}' for w in walls)} ms")
    del out, out_rubix, out_rgb, plain, plain_rubix, plain_rgb

    # ---------------------------------------------------------------- 3
    B3 = 8
    f3 = frames[..., :B3].copy()
    rgba = remap.frames_to_rgba(f3, sess.palette)
    cases = {
        "u8": (f3, {}),
        "u8 rubix (LUT)": (f3, dict(rubix=True)),
        "u8 decode_rgb (LUT)": (f3, dict(decode_rgb=True)),
        "u8 rubix+decode (LUT)": (f3, dict(rubix=True, decode_rgb=True)),
        "expanded rubix u8": (remap.expand_frames_tinted(f3, sess.palette),
                              dict(rubix=True)),
        "expanded rubix+decode": (remap.expand_frames_tinted(f3, sess.palette),
                                  dict(rubix=True, decode_rgb=True)),
        "rgba u32": (rgba, {}),
        "rgba u32 post-gather tint": (rgba, dict(rubix=True)),
        "rgba u32 expanded": (remap.expand_frames_tinted_rgba(rgba), dict(rubix=True)),
    }
    rng = np.random.default_rng(0)
    bg = rng.integers(0, 256, (1080, 1920), dtype=np.uint8)
    bad = lm.flat_idx.copy()
    pick = rng.random(bad.shape) < 0.05
    R = 6 * 1080 * 1080
    bad[pick] = rng.choice(np.array([-1, -R, -R - 1, R, 3 * R, 2**31 - 1], np.int32),
                           pick.sum())
    oob = dataclasses.replace(lm, flat_idx=bad, valid=lm.valid & (rng.random(bad.shape) > 0.1))
    for lmap, tag in ((lm, ""), (oob, " out-of-range idx + holes")):
        card_kernel = remap.RemapKernel(lmap, sess.palette, bg, device=dev)
        plain_kernel = remap.RemapKernel(lmap, sess.palette, bg, device="cpu")
        for name, (fr, kw) in cases.items():
            got = card_kernel(fr, **kw)
            ref = plain_kernel(fr, **kw)  # CPU tensors: the plain versions
            require(got.dtype == ref.dtype and got.shape == ref.shape,
                    f"{name}{tag}: {got.dtype} {tuple(got.shape)}")
            require(np.array_equal(got.cpu().numpy(), ref.numpy()),
                    f"{name}{tag}: kernel differs from the plain version")
            if not tag:
                require(np.array_equal(
                    got[..., 0, :].cpu().numpy() if kw.get("decode_rgb") and fr.dtype == np.uint8
                    else got[..., 0].cpu().numpy(),
                    remap.host_remap(lmap, fr[..., 0], sess.palette, bg, **kw)),
                    f"{name}: frame 0 differs from host_remap")
        phase(3, f"RemapKernel 1080p B={B3}{tag}: {len(cases)} source kinds "
              "bit-equal the plain versions" + ("" if tag else " and host_remap"))

    # ---------------------------------------------------------------- 4
    for batch in (1024, 4096):
        torch.cuda.empty_cache()
        r = run_gather_throughput(batch=batch, iters=ITERS, rubix=False,
                                  texel_compact=True, device=dev, plain=True)
        require(r["equal"], f"headline B={batch}: kernel differs from the plain version")
        phase(4, f"{r['config']}: K1 {r['ms_per_batch']:.4f} ms/batch "
              f"{r['fps']:.1f} frames/s {r['gbps']:.1f} GB/s; plain (index_select + "
              f"where) {r['plain_ms_per_batch']:.4f} ms/batch {r['plain_fps']:.1f} "
              f"frames/s {r['plain_gbps']:.1f} GB/s; {r['bytes_per_batch']} bytes/batch; "
              f"byte bound {r['bound_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"({100 * r['bound_bytes'] / HBM_BYTES_PER_S * 1e3 / r['ms_per_batch']:.1f} %); "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---------------------------------------------------------------- 5
    onehots = [p for p in probes if p["probe"] == "onehot_gather"]
    mxu = {p["dtype"]: p for p in probes if p["probe"] == "mxu_matmul"}
    (sr,) = (p for p in probes if p["probe"] == "stream_read")
    for p in onehots:
        require(p["equal"], f"onehot_gather (source values < {p['src_hi']}) differs "
                f"from the plain version (max {p['max_abs_err']})")
        bound_ms = p["bytes"] / HBM_BYTES_PER_S * 1e3
        phase(5, f"onehot_gather {p['windows']}x{p['T']}x{p['R']}x{p['B']}, source "
              f"values < {p['src_hi']}: kernel {p['ms']:.4f} ms ({p['tmacs']:.2f} TMAC/s, "
              f"{p['ns_per_index']:.3f} ns/index, full 1080p screen "
              f"{p['full_screen_ms']:.4f} ms), plain {p['plain_ms']:.4f} ms; bit-equal; "
              f"the gather's {p['bytes']} bytes, bound {bound_ms:.4f} ms, "
              f"{100 * bound_ms / p['ms']:.1f} % of it ({p['gbps']:.1f} GB/s)")
    oh = onehots[0]
    phase(5, f"one-hot gather as a matrix product, a full 1080p screen at B={oh['B']}: "
          f"{oh['full_screen_ms']:.4f} ms; K1's direct gather of a 1080p screen at "
          f"B={B_MAIN}: {main_ms['remap_gather']['ms']:.4f} ms")
    phase(5, "matrix-product rate at the one-hot gather's shapes (torch._int_mm, "
          "torch.matmul): " + ", ".join(
              f"{d} {p['m']}x{p['k']}x{p['n']} {p['ms']:.4f} ms {p['tmacs']:.2f} TMAC/s"
              for d, p in mxu.items()) + f"; K3 {oh['tmacs']:.2f} TMAC/s")
    require(oh["library_equal"], "torch.gather differs from onehot_gather")
    phase(5, f"onehot_gather's library call, {oh['library']}: {oh['library_ms']:.4f} ms")
    (sc,) = (p for p in probes if p["probe"] == "stream_copy")
    phase(5, f"stream_copy (x + 1, a plain torch call) {sc['bytes']} bytes: {sc['ms']:.4f} ms, "
          f"{sc['gbps']:.1f} GB/s read + written")
    for p in probes:
        if p["probe"] in ("row_gather", "element_gather"):
            call = "src.index_select(0, idx)" if p["probe"] == "row_gather" else "torch.take(src, idx)"
            phase(5, f"{p['probe']} ({call}, a plain torch call) {p['n_idx']} indices into "
                  f"{p['rows']} rows of {p['row_bytes']} bytes: {p['ms']:.4f} ms, "
                  f"{p['ns_per_index']:.3f} ns/index, {p['gbps']:.1f} GB/s read + written")
    require(sr["equal"], "stream_read differs from the plain version")
    phase(5, f"stream_read {sr['bytes']} bytes: kernel {sr['ms']:.4f} ms "
          f"({sr['gbps']:.1f} GB/s), plain {sr['plain_ms']:.4f} ms "
          f"({sr['plain_gbps']:.1f} GB/s), library call {sr['library']} "
          f"{sr['library_ms']:.4f} ms")

    posed_launches, posed_rows = posed_phase(dev, frames, frames_dev, kernels)
    launches.update(posed_launches)
    builder_launches, builder_rows = builder_phase(dev, frames, frames_dev, kernels, lm,
                                                   lensmap_s)
    launches.update(builder_launches)
    main_rows = {"remap_gather": main_ms["remap_gather"]["ms"],
                 "remap_lut": main_ms["remap_lut"]["ms"],
                 **{row[0]: row[4] for row in posed_rows + builder_rows}}
    for name, n in random_globes_phase(dev, main_rows).items():
        launches[name] += n
    equirect_launches, equirect_rows = equirect_phase(dev, frames, frames_dev, kernels)
    launches.update(equirect_launches)
    lenses_phase(dev, frames, frames_dev, kernels)
    lua_launches, lua_rows = lua_phase(dev, frames, frames_dev, kernels)
    launches.update(lua_launches)
    surface_phase(dev, frames, frames_dev, kernels)
    for name, n in recorded_phase(dev, kernels).items():
        launches[name] += n
    for name, n in mesh_phase(dev, frames, frames_dev, lm).items():
        launches[name] += n
    for name, n in bench_launches.items():
        launches[name] += n

    print(f"chip_smoke: every phase passed in {time.perf_counter() - script_t0:.1f} s",
          flush=True)
    k1, k2 = main_ms["remap_gather"], main_ms["remap_lut"]
    rows = [
        ("remap_gather", "remap_gather.cu", "blinky_tpu/kernels/remap.py:88",
         err["render"], k1["ms"], k1["plain_ms"], k1["bound_ms"], "bytes", None, None),
        ("remap_lut", "remap_lut.cu", "blinky_tpu/kernels/remap.py:56",
         max(err["render f_rubix"], err["render decode_rgb"]), k2["ms"], k2["plain_ms"],
         k2["bound_ms"], "bytes", None, None),
        ("onehot_gather", "sol.cu", "blinky_tpu/bench/sol.py:149",
         max(p["max_abs_err"] for p in onehots), oh["ms"], oh["plain_ms"],
         oh["bytes"] / HBM_BYTES_PER_S * 1e3, "bytes", oh["library_ms"], oh["library"]),
        ("stream_read", "sol.cu", "blinky_tpu/bench/sol.py:222",
         sr["max_abs_err"], sr["ms"], sr["plain_ms"],
         (sr["bytes"] + 4) / HBM_BYTES_PER_S * 1e3, "bytes", sr["library_ms"], sr["library"]),
    ] + posed_rows + builder_rows + equirect_rows + lua_rows
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": os.path.normpath(f"blinky_tpu_torch/csrc/{src_file}"),
         "replaces": replaces, "launches": launches[name], "max_abs_err": e,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": library_ms, "library": library}
        for name, src_file, replaces, e, ms, plain_ms, bound_ms, bound_by, library_ms,
        library in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


POSED_B = 64
CHUNK = 8
SCRIPT_CELL_B = 1024  # lfast.posed_card's poses a call


def k6_ops_per_pose_pixel(globe):
    """Float32 operations K6 does for one pose and build pixel: the shared
    resolve's (bench/builder.py::resolve_ops_per_pixel counts them as
    csrc/resolve.cuh does them), the rotation included."""
    from blinky_tpu_torch.bench.builder import resolve_ops_per_pixel

    return resolve_ops_per_pixel(globe, rotate=True)


def posed_phase(dev, frames, frames_dev, kernels):
    """Phase 6: the posed path.  Returns (the launches of K5, K6 and K7 in
    the path's run, their rows of the kernels line)."""
    from blinky_tpu_torch import budget
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench.posed import posed_poses
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.kernels import posed, remap, static_ray
    from blinky_tpu_torch.lensmap import build_lensmap, calc_scale
    from blinky_tpu_torch.lensmap.builder import TINT_NONE, rays_to_lensmap_torch
    from blinky_tpu_torch.palette import MAX_PLATES, rgba_lut

    poses = posed_poses(POSED_B)
    bases_np = posed.bases_from_pose_track(poses)
    sess = Session(1920, 1080, device=dev)
    S, H, W = 1080, 1080, 1920
    t0 = time.perf_counter()
    expanded_dev = torch.from_numpy(remap.expand_frames_tinted(frames, sess.palette)).to(dev)
    lut = torch.from_numpy(rgba_lut(sess.palette).view(np.int32)).to(dev)
    rgba_dev = lut[frames_dev.long()].view(torch.uint32)
    phase(6, f"sources on the card (u8 {tuple(frames_dev.shape)}, expanded "
          f"{tuple(expanded_dev.shape)}, RGBA u32) in {time.perf_counter() - t0:.3f} s")
    sources = {"u8": frames_dev, "expanded": expanded_dev, "rgba": rgba_dev}

    # ------------------------------------------------ the path, counted
    path_kernels = [posed.gather_posed, static_ray.static_ray_posed, posed.posed_layout]
    for fn in list(kernels.values()) + path_kernels:
        fn.launches = 0
    outs, kerns = {}, {}
    for kind, fr in sources.items():
        for k in (1, 2):
            t0 = time.perf_counter()
            outs[kind, k] = sess.render_posed(fr, poses, render_scale=k)
            torch.cuda.synchronize()
            kerns[kind, k] = sess._posed_cache[1]
            phase(6, f"render_posed {kind} render_scale={k}: {tuple(outs[kind, k].shape)} "
                  f"{outs[kind, k].dtype} in {time.perf_counter() - t0:.3f} s (with the "
                  "set-up of a new kernel: ray table and upload)")
    exact = sess.render_posed(frames_dev[..., :2], poses[:2], exact=True)
    torch.cuda.synchronize()
    launches = {"posed_gather": posed.gather_posed.launches,
                "static_ray_posed": static_ray.static_ray_posed.launches,
                "posed_layout": posed.posed_layout.launches}
    phase(6, f"launches in the posed path's run: {launches}; K7's long-row path "
          f"(posed.long_row_path, rows of {posed.LONG_ROW_MIN_BYTES[1]} bytes and more of u8, "
          f"{posed.LONG_ROW_MIN_BYTES[4]} of RGBA) took {posed.posed_layout.long_row_launches} "
          "of them")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the posed path")

    # ------------------------------------------------ checks
    def operands(kind, k, lo, hi):
        kern = kerns[kind, k]
        src, bases, expanded = posed.prep_posed_inputs(
            sources[kind][..., lo:hi], bases_np[lo:hi], S, kern.background, dev)
        return kern, src, bases, expanded

    def plain_chunk(kind, k, lo, hi):
        kern, src, bases, expanded = operands(kind, k, lo, hi)
        return static_ray.static_ray_posed_plain(
            src, kern.ray_table, bases, kern.globe, S, kern.numcells, kern.cell_size,
            kern.pad_size, expanded, kern.background, k)

    err = 0
    for (kind, k), out in outs.items():
        bits = out.view(torch.int32) if out.dtype == torch.uint32 else out
        for lo in range(0, POSED_B, CHUNK):
            ref = plain_chunk(kind, k, lo, lo + CHUNK)
            got = bits[lo:lo + CHUNK]
            e = int((got.long() - ref.long()).abs().max())
            require(torch.equal(got, ref), f"render_posed {kind} k={k} poses {lo}.. differ "
                    f"from static_ray_posed_plain (max {e})")
            err = max(err, e)
    phase(6, f"render_posed at 1080p B={POSED_B}: u8, expanded and RGBA at render_scale 1 "
          "and 2 bit-equal static_ray_posed_plain on the card")
    static = sess.render(frames_dev[..., :1])[..., 0]
    ident = float((outs["u8", 1][0] != static).float().mean())
    phase(6, f"identity pose against the static exact render: {ident:.6f} of the pixels "
          "differ (float32 uv against float64)")
    require(ident <= 0.02, f"identity pose differs from the static render at {ident}")
    scale = kerns["u8", 1].scale
    for b in range(2):
        lm = build_lensmap(sess.lens, sess.globe, scale, W, H, S, view_basis=tuple(bases_np[b]))
        host = remap.host_remap(lm, frames[..., b], sess.palette)
        require(np.array_equal(exact[b].cpu().numpy(), host),
                f"render_posed(exact=True) pose {b} differs from host_remap")
    phase(6, "render_posed(exact=True) of two poses bit-equal host_remap of the exact "
          "host build at each pose")
    t0 = time.perf_counter()
    auto = sess.render_posed(frames_dev, poses, render_scale="auto", target_fps=60.0)
    torch.cuda.synchronize()
    t21, t81, t2h, k_hi = sess._auto_scale_probes[1]
    k_auto = sess._posed_cache[0][-1]  # the kernel's key ends with its scale
    require(torch.equal(auto, sess.render_posed(frames_dev, poses, render_scale=k_auto)),
            "render_scale='auto' differs from its explicit scale")
    phase(6, f"render_scale='auto' at 60 fps, B={POSED_B}: picks k={k_auto} in "
          f"{time.perf_counter() - t0:.3f} s; probes (B=2, k=1) {t21 * 1e3:.3f} ms, "
          f"(B=8, k=1) {t81 * 1e3:.3f} ms, (B=2, k={k_hi}) {t2h * 1e3:.3f} ms")
    del auto, exact, outs

    # K5's operands: the plain version's tables for poses lo .. hi - 1
    def tables(kind, k, lo, hi):
        kern, src, bases, expanded = operands(kind, k, lo, hi)
        lm = rays_to_lensmap_torch(kern.globe, kern.ray_table.vx, kern.ray_table.vy,
                                   kern.ray_table.vz, kern.ray_table.lens_valid, S,
                                   kern.numcells, kern.cell_size, kern.pad_size,
                                   view_basis=bases)
        idx, valid = lm["flat_idx"], lm["valid"]
        if expanded:
            idx = idx + torch.where((lm["tint"] != TINT_NONE) & valid,
                                    MAX_PLATES * S * S, 0).to(torch.int32)
        return src, idx.contiguous(), valid.contiguous(), kern.background

    # ------------------------------------------------ times and bounds
    def texels(idx, valid):  # distinct source texels the valid pixels read
        return sum(int(torch.unique(idx[b][valid[b]]).numel()) for b in range(idx.shape[0]))

    def reads(kind, k, batch):  # distinct texels over the batch
        return sum(texels(*tables(kind, k, lo, min(batch, lo + CHUNK))[1:3])
                   for lo in range(0, batch, CHUNK))

    # K5 alone on the plain version's indices: each source kind at render
    # scales 1 and 2, bit-checked, then timed beside its plain version and
    # its byte bound (the tables, the distinct texels, the background and
    # the screens, each read or written once)
    k5 = {}
    for kind in sources:
        for k in (1, 2):
            parts = [tables(kind, k, lo, lo + CHUNK) for lo in range(0, POSED_B, CHUNK)]
            idx = torch.cat([p_[1] for p_ in parts])
            valid = torch.cat([p_[2] for p_ in parts])
            bg5 = parts[0][3]
            del parts
            src5, _, _ = posed.prep_posed_inputs(sources[kind], bases_np, S, bg5, dev)
            run = lambda s5=src5, i=idx, v=valid, g=bg5, k=k: posed.gather_posed(s5, i, v, g, k)  # noqa: E731
            plain = lambda s5=src5, i=idx, v=valid, g=bg5, k=k: posed.gather_posed_plain(s5, i, v, g, k)  # noqa: E731
            got, ref = run(), plain()
            e = int((got.long() - ref.long()).abs().max())
            require(torch.equal(got, ref),
                    f"gather_posed {kind} k={k} differs from its plain version ({e})")
            el = src5.element_size()
            nbytes = (idx.numel() * 5 + texels(idx, valid) * el + bg5.numel() * bg5.element_size()
                      + got.numel() * got.element_size())
            del got, ref
            ms, plain_ms = cuda_ms_pair(run, plain)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            k5[kind, k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, err=e)
            phase(6, f"K5 gather_posed {kind} k={k} 1080p B={POSED_B} on the plain version's "
                  f"indices: bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {nbytes} "
                  f"bytes, bound {bound:.4f} ms by bytes, {100 * bound / ms:.1f} % of it")
            if (kind, k) == ("u8", 1):
                flat = idx.reshape(POSED_B, -1).long()
                gather_ms = cuda_ms(lambda: torch.gather(src5, 1, flat), ITERS)
                phase(6, f"torch.gather(src, 1, idx) alone on the u8 k=1 tables {gather_ms:.4f} "
                      "ms (context, not the same function)")
                del flat
            del run, plain, idx, valid, src5
            torch.cuda.empty_cache()
    k5_err = max(v["err"] for v in k5.values())
    k5main = k5["u8", 1]

    k6 = {}
    ops_pp = k6_ops_per_pose_pixel(sess.globe)
    for batch in (POSED_B, 1):
        for kind in sources:
            for k in (1, 2):
                texel_n = reads(kind, k, batch)
                kern, src, bases, expanded = operands(kind, k, 0, batch)
                npix = kern.ray_table.vx.numel()
                el = src.element_size()
                nbytes = (npix * 13 + batch * 36 + texel_n * el + H * W * el
                          + batch * H * W * el)
                # the expanded source's rubix grid test needs no float64
                # operation a pixel: it is two lookups in a table of S flags
                # (lensmap/builder.py::rubix_grid_lines), counted like the
                # index arithmetic, not at all
                f32_ops = ops_pp * npix * batch
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = f32_ops / F32_OPS_PER_S * 1e3
                args = (src, kern.ray_table, bases, kern.globe, S, kern.numcells,
                        kern.cell_size, kern.pad_size, expanded, kern.background, k)
                ms, plain_ms = cuda_ms_pair(lambda: static_ray.static_ray_posed(*args),
                                            lambda: static_ray.static_ray_posed_plain(*args))
                # the kernel's own device time, from its CUPTI record
                _, dev_ms, _ = profiled(lambda: static_ray.static_ray_posed(*args), ITERS,
                                        sync=False)
                k6_dev = sum(t for n_, t in dev_ms.items() if "static_ray_posed" in n_)
                # the wrapper's host time a call: where it is near the kernel
                # time, the events measured the host, not the card
                enqueue_ms = host_ms(lambda: [static_ray.static_ray_posed(*args)
                                              for _ in range(ITERS)]) / ITERS
                torch.cuda.synchronize()
                bound = max(bytes_ms, ops_ms)
                k6[batch, kind, k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                          bound_by="operations" if ops_ms >= bytes_ms
                                          else "bytes")
                phase(6, f"K6 static_ray_posed {kind} k={k} B={batch}: kernel {ms:.4f} ms by "
                      f"the events, {k6_dev:.4f} ms by the profiler's kernel record, "
                      f"plain {plain_ms:.4f} ms; {nbytes} bytes ({bytes_ms:.4f} ms), "
                      f"{f32_ops} f32 operations ({ops_ms:.4f} ms); bound "
                      f"{bound:.4f} ms by {k6[batch, kind, k]['bound_by']}, "
                      f"{100 * bound / ms:.1f} % of it ({100 * bound / k6_dev:.1f} % by the "
                      f"kernel record); the wrapper's host time {enqueue_ms:.4f} ms a call")
                del args, src
                torch.cuda.empty_cache()

    for k in (1, 2):
        t0 = time.perf_counter()
        static_ray.ray_table_from_lens(sess.lens, scale * k, W // k, H // k)
        phase(6, f"host ray table {W // k}x{H // k} (float64 lens stage, k={k}): "
              f"{time.perf_counter() - t0:.3f} s")
    # K7, the pose-major layout: against its plain version and the library
    # call permute().contiguous(), with its byte bound (the poses' texels
    # read once, the pose-major array written once) and, for a batch slice,
    # the floors of reading each texel row's bytes as whole 32-byte sectors
    # and as whole 64-byte segments.  Every source at B=64 (the vector path)
    # and on a one-pose slice; u8 and RGBA also as contiguous ragged batches
    # (B = 63, and the auto probes' B = 2 and 8) and on a chunk slice
    # [..., 0:40] of the batch, the shapes of the tile path.
    layout = {}
    cases = {"B=64": lambda b: b, "B=63 contiguous": lambda b: b[..., :63].contiguous(),
             "B=2 contiguous": lambda b: b[..., :2].contiguous(),
             "B=8 contiguous": lambda b: b[..., :8].contiguous(),
             "slice [..., 0:40]": lambda b: b[..., 0:40],
             "one-pose slice [..., 0:1]": lambda b: b[..., :1]}
    for kind, fr in sources.items():
        bits = fr.view(torch.int32) if fr.dtype == torch.uint32 else fr
        planes = bits.shape[0]
        for tag, cut in cases.items():
            if kind == "expanded" and tag not in ("B=64", "one-pose slice [..., 0:1]"):
                continue
            x = cut(bits)
            batch = x.shape[-1]
            run = lambda x=x, planes=planes: posed.posed_layout(x, planes)  # noqa: E731
            lib = lambda x=x: x.permute(3, 0, 1, 2).contiguous()  # noqa: E731
            require(torch.equal(run(), lib().reshape(batch, -1)),
                    f"posed_layout {kind} {tag} differs from permute().contiguous()")
            require(torch.equal(run(), posed.posed_layout_plain(x, planes)),
                    f"posed_layout {kind} {tag} differs from its plain version")
            ms, lib_ms = cuda_ms_pair(run, lib)
            plain_ms = cuda_ms(lambda x=x, planes=planes: posed.posed_layout_plain(x, planes),
                               ITERS)
            _, dev_ms, _ = profiled(run, ITERS, sync=False)
            k7_dev = sum(t for n_, t in dev_ms.items() if "posed_layout" in n_)
            el = x.element_size()
            out_bytes = batch * planes * S * S * el
            nbytes = x.numel() * el + out_bytes
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            layout[kind, tag] = dict(ms=ms, dev_ms=k7_dev, plain_ms=plain_ms,
                                     library_ms=lib_ms, bound_ms=bound)
            floors = ""
            if not x.is_contiguous():
                rows, head = x.numel() // batch, x.data_ptr() % 64  # the rows lie 64 or 256 bytes apart
                for seg in (32, 64):
                    fb = rows * ((head % seg + batch * el + seg - 1) // seg) * seg + out_bytes
                    f_ms = fb / HBM_BYTES_PER_S * 1e3
                    floors += (f"; {seg}-byte {'sector' if seg == 32 else 'segment'} floor "
                               f"{fb} bytes, {f_ms:.4f} ms, {100 * f_ms / k7_dev:.1f} % of it")
            phase(6, f"K7 posed_layout {kind} {tag}: kernel {ms:.4f} ms by the events, "
                  f"{k7_dev:.4f} ms by the kernel record; plain {plain_ms:.4f} ms, "
                  f"permute().contiguous() {lib_ms:.4f} ms; {nbytes} bytes, bound {bound:.4f} ms, "
                  f"{100 * bound / k7_dev:.1f} % of it by the record "
                  f"({nbytes / (k7_dev * 1e-3) / 1e9:.1f} GB/s){floors}; bit-equal to both")
            del x
            torch.cuda.empty_cache()
        one = fr[..., :1].contiguous()  # the drag-look: one whole frame set
        n7 = posed.posed_layout.launches
        bg1 = kerns[kind, 1].background
        view_ms = min(host_ms(lambda: posed.prep_posed_inputs(one, bases_np[:1], S, bg1, dev))
                      for _ in range(3))
        src1, _, _ = posed.prep_posed_inputs(one, bases_np[:1], S, bg1, dev)
        require(posed.posed_layout.launches == n7 and src1.data_ptr() == one.data_ptr(),
                f"prep_posed_inputs of one contiguous {kind} pose copied its frames")
        phase(6, f"prep_posed_inputs {kind} B=1, contiguous: a view of the frames, no "
              f"launch, {view_ms:.3f} ms of host time")
    # K7 on long rows, 1 KB a texel: the posed cell's u8 B = 1024 and RGBA
    # B = 256, random bytes made on the card, every launch on the long-row path
    gen = torch.Generator(dev).manual_seed(1024)
    big = torch.randint(0, 256, (MAX_PLATES, S, S, 1024), dtype=torch.uint8, device=dev,
                        generator=gen)
    for kind, x in (("u8", big), ("rgba", big.view(torch.int32))):
        batch, el = x.shape[-1], x.element_size()
        n7, l7 = posed.posed_layout.launches, posed.posed_layout.long_row_launches
        run = lambda x=x: posed.posed_layout(x, MAX_PLATES)  # noqa: E731
        require(torch.equal(run(), posed.posed_layout_plain(x, MAX_PLATES)),
                f"posed_layout {kind} B={batch} differs from its plain version")
        require(torch.equal(run(), x.permute(3, 0, 1, 2).contiguous().reshape(batch, -1)),
                f"posed_layout {kind} B={batch} differs from permute().contiguous()")
        ms, lib_ms = cuda_ms_pair(run, lambda x=x: x.permute(3, 0, 1, 2).contiguous())
        plain_ms = cuda_ms(lambda x=x: posed.posed_layout_plain(x, MAX_PLATES), ITERS)
        _, dev_ms, _ = profiled(run, ITERS, sync=False)
        k7_dev = sum(t for n_, t in dev_ms.items() if "posed_layout" in n_)
        nbytes = 2 * x.numel() * el
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        n_long = posed.posed_layout.long_row_launches - l7
        require(n_long == posed.posed_layout.launches - n7,
                f"posed_layout {kind} B={batch}: {n_long} of "
                f"{posed.posed_layout.launches - n7} launches on the long-row path")
        layout[kind, f"B={batch}"] = dict(ms=ms, dev_ms=k7_dev, plain_ms=plain_ms,
                                          library_ms=lib_ms, bound_ms=bound)
        phase(6, f"K7 posed_layout {kind} B={batch} (rows of {batch * el} bytes, the "
              f"long-row path: {n_long} launches, every one): kernel {ms:.4f} ms by the "
              f"events, {k7_dev:.4f} ms by the kernel record ("
              + ", ".join(n_[:48] for n_ in dev_ms) + f"); plain {plain_ms:.4f} ms, "
              f"permute().contiguous() {lib_ms:.4f} ms; {nbytes} bytes, bound {bound:.4f} ms, "
              f"{100 * bound / k7_dev:.1f} % of it by the record "
              f"({nbytes / (k7_dev * 1e-3) / 1e9:.1f} GB/s); bit-equal to both")
        torch.cuda.empty_cache()
    del big
    torch.cuda.empty_cache()

    # render_posed u8 k=1, frames on the card: the pose bases, K7, K6 and the
    # rest of the host wall clock, with the device's idle share, from
    # profiler runs of ITERS calls (each synchronised) given the poses, and
    # given their bases (the difference is the pose bases' host time)
    one_u8 = frames_dev[..., :1].contiguous()
    for batch, fr in ((POSED_B, frames_dev), (1, one_u8)):
        # the zoom solve and the memory query run only for a new kernel key
        # or a batch above the cap last read, so not in the timed calls
        steps = {"zoom solve": lambda: calc_scale(sess.zoom, sess.lens, W, H),
                 "memory query": lambda: budget.device_memory_bytes(dev)}
        host = {name: min(host_ms(fn) for _ in range(3)) for name, fn in steps.items()}
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            sess.render_posed(fr, poses[:batch])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall, dev_ms, busy = profiled(lambda: sess.render_posed(fr, poses[:batch]), ITERS)
        wall_b, _, _ = profiled(lambda: sess.render_posed(fr, bases_np[:batch]), ITERS)
        k7 = sum(t for n_, t in dev_ms.items() if "posed_layout" in n_)
        k6_ = sum(t for n_, t in dev_ms.items() if "static_ray_posed" in n_)
        phase(6, f"render_posed u8 k=1 B={batch}, frames on the card: host wall clock "
              f"{', '.join(f'{w:.3f}' for w in walls)} ms; under the profiler {wall:.3f} ms "
              f"a call = pose bases {wall - wall_b:.3f} (the call given its bases: "
              f"{wall_b:.3f} ms) + K7 {k7:.4f} + K6 {k6_:.4f} + the rest "
              f"{wall_b - k7 - k6_:.3f} ms; device busy {busy:.4f} ms, idle "
              f"{100 * (1 - busy / wall):.1f} % of the call; device work by record: "
              + ", ".join(f"{n_[:40]} {t:.4f} ms" for n_, t in dev_ms.items())
              + f"; once a key: {', '.join(f'{n} {t:.3f} ms' for n, t in host.items())}")

    main6 = k6[POSED_B, "u8", 1]
    k7main = layout["u8", "B=64"]
    rows = [
        ("posed_gather", "posed.cu", "blinky_tpu/kernels/posed.py:102", k5_err, k5main["ms"],
         k5main["plain_ms"], k5main["bound_ms"], "bytes", None, None),
        ("static_ray_posed", "posed.cu", "blinky_tpu/kernels/static_ray.py:220", err,
         main6["ms"], main6["plain_ms"], main6["bound_ms"], main6["bound_by"], None, None),
        ("posed_layout", "layout.cu", "blinky_tpu/kernels/posed.py:91", 0, k7main["ms"],
         k7main["plain_ms"], k7main["bound_ms"], "bytes", k7main["library_ms"],
         "x.permute(3, 0, 1, 2).contiguous()"),
    ]
    return launches, rows


SWEEP_STEPS = 24
F32_SHARE = 0.15  # tests/test_lensmap_parity.py's bound for float32 noise at 64x48
VIEWS = {"identity": None, "setviewangles 10 30 0": (10.0, 30.0, 0.0),
         "(-75, 200, 33)": (-75.0, 200.0, 33.0)}


def builder_phase(dev, frames, frames_dev, kernels, exact_lm, exact_s):
    """Phase 7: the float32 device builder's paths.  Returns (the launches of
    K8 and K9 in the paths' run, their rows of the kernels line)."""
    from blinky_tpu_torch import budget, globes, lenses
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import builder as bb
    from blinky_tpu_torch.bench.posed import posed_poses
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.camera import view_basis_from_angles
    from blinky_tpu_torch.kernels import posed, remap, static_ray
    from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
    from blinky_tpu_torch.lensmap import builder

    S, H, W = 1080, 1080, 1920
    npix = H * W
    poses = posed_poses(POSED_B)
    bases_np = posed.bases_from_pose_track(poses)
    probe = Session(W, H, device="cpu")  # state only: lens, globe, palette
    lens, globe, pal = probe.lens, probe.globe, probe.palette
    scale = calc_scale(probe.zoom, lens, W, H)
    expanded_dev = torch.from_numpy(remap.expand_frames_tinted(frames, pal)).to(dev)
    frame, frame_x = frames[..., 0], remap.expand_frames_tinted(frames[..., 0], pal)
    fovs = bb.sweep_fovs(steps=SWEEP_STEPS)
    scales = bb.sweep_scales(lens, W, H, fovs)

    # ------------------------------------------------ the paths, counted
    path_kernels = [builder.lensmap_resolve, posed.sweep_remap, posed.gather_posed,
                    static_ray.static_ray_posed, posed.posed_layout]
    for fn in list(kernels.values()) + path_kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = build_lensmap(lens, globe, scale, W, H, S, backend="torch", device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    sess = Session(W, H, device=dev, backend="torch")        # a
    out_a = sess.render(frames_dev)
    lm_a = sess._lensmap
    auto = Session(W, H, device=dev)                         # b
    auto.cmd("setviewangles 10 30 0")
    out_b = auto.render(frames_dev)
    lm_b = auto._lensmap
    require(auto._resolved_backend() == "torch" and sess._resolved_backend() == "torch",
            "the Session did not take the float32 device builder")
    fused, outs_c = {}, {}                                   # c
    for kind, fr in (("u8", frames_dev), ("expanded", expanded_dev)):
        for k in (1, 2):
            fused[kind, k] = posed.PosedRemapKernel(lens, globe, W, H, scale, platesize=S,
                                                    render_scale=k, device=dev)
            outs_c[kind, k] = fused[kind, k](fr, bases_np)
    outs_d = {kind: posed.zoom_sweep_remap(lens, globe, scales, fr, W, H, device=dev)  # d
              for kind, fr in (("u8", frame), ("expanded", frame_x))}
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in list(kernels.values()) + path_kernels}
    launches = {"lensmap_resolve": builder.lensmap_resolve.launches,
                "sweep_remap": posed.sweep_remap.launches}
    phase(7, f"launches in the device-builder paths' run (a: Session(backend='torch') render, "
          f"b: setviewangles 10 30 0 under 'auto', c: PosedRemapKernel u8 and expanded at "
          f"k = 1, 2, d: zoom_sweep_remap of {SWEEP_STEPS} steps, u8 and expanded): {counts}; "
          f"the first build_lensmap(backend='torch') of the process {first_s * 1e3:.3f} ms")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the device-builder paths")
    for name in ("remap_gather", "static_ray_posed", "posed_layout"):
        require(counts[name] >= 1, f"{name} was not launched by the device-builder paths")

    # ------------------------------------------------ K8 against its plain version
    def tables_equal(got, want, what):
        err = 0
        for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
            e = int((got[f].long() - want[f].long()).abs().max())
            require(got[f].dtype == want[f].dtype and torch.equal(got[f], want[f]),
                    f"lensmap_resolve {what}: {f} differs from rays_to_lensmap_torch (max {e})")
            err = max(err, e)
        return err

    k8_err = 0
    rays = {}
    for gname in ("cube", "fast"):
        g = globes.get(gname)
        rays[gname] = builder.lens_rays_torch(lenses.get("panini", g), scale, W, H, dev)
        for vname, angles in VIEWS.items():
            vb = builder.IDENTITY_BASIS if angles is None else view_basis_from_angles(*angles)
            got = builder.lensmap_resolve(g, *rays[gname], S, 10, 4.0, 1.0, vb)
            want = builder.rays_to_lensmap_torch(
                g, *rays[gname], S, 10, 4.0, 1.0,
                view_basis=torch.from_numpy(builder.basis_f32(vb)).to(dev))
            k8_err = max(k8_err, tables_equal(got, want, f"{gname}, {vname}"))
            del got, want
    phase(7, "lensmap_resolve (K8) at 1080p on the cube and the fast globe, the identity and "
          "two rotated bases: every table bit-equal to rays_to_lensmap_torch on the same rays")
    for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
        require(torch.equal(getattr(first, f), getattr(lm_a, f)),
                f"two float32 builds of one lensmap differ in {f}")

    # the float32 build against the exact host build of phase 2
    f32 = lm_a.to_numpy()
    share = float((f32.flat_idx != exact_lm.flat_idx).mean())
    same = f32.valid & exact_lm.valid & (f32.plate == exact_lm.plate)
    off = max(int(np.abs(getattr(f32, f) - getattr(exact_lm, f))[same].max(initial=0))
              for f in ("px", "py"))
    phase(7, f"float32 device build against the exact host build: flat_idx differs on "
          f"{share:.6f} of the pixels ({int((f32.flat_idx != exact_lm.flat_idx).sum())} of "
          f"{npix}); valid differs on {int((f32.valid != exact_lm.valid).sum())}; where both "
          f"are valid on one plate px and py differ by at most {off} texel; plates_used "
          f"{f32.plates_used.astype(int).tolist()} against "
          f"{exact_lm.plates_used.astype(int).tolist()}")
    require(share <= F32_SHARE and off <= 1,
            f"the float32 build is not within the boundary tolerance of the exact one "
            f"({share}, {off})")

    # ------------------------------------------------ a and b: the renders
    src = frames_dev.reshape(-1, B_MAIN)
    for name, out, sess_, lm in (("Session(backend='torch').render", out_a, sess, lm_a),
                                 ("render after setviewangles 10 30 0", out_b, auto, lm_b)):
        flat = lambda t: t.reshape(-1)  # noqa: E731
        bg = torch.zeros(npix, dtype=torch.uint8, device=dev)
        plain = remap.remap_gather_plain(src, flat(lm.flat_idx), flat(lm.valid), bg,
                                         fill=True).reshape(out.shape)
        require(torch.equal(out, plain), f"{name} differs from the plain version")
        host = remap.host_remap(sess_.lensmap, frames[..., 0], sess_.palette)
        require(np.array_equal(out[..., 0].cpu().numpy(), host),
                f"{name}: frame 0 differs from host_remap of the same table")
        del plain
    moved = float((lm_a.flat_idx != lm_b.flat_idx).float().mean())
    require(moved > 0.5, f"setviewangles 10 30 0 moved only {moved} of the lensmap")
    phase(7, "Session(backend='torch').render and the render after setviewangles 10 30 0 "
          f"(B={B_MAIN}) bit-equal the plain version on the card and host_remap of the same "
          f"table for frame 0; the rotation moved {moved:.4f} of the lensmap's indices")

    # ------------------------------------------------ c: the fused posed pipeline
    for (kind, k), out in outs_c.items():
        kern = fused[kind, k]
        fr = frames_dev if kind == "u8" else expanded_dev
        for lo in range(0, POSED_B, CHUNK):
            src_c, b32, exp = posed.prep_posed_inputs(fr[..., lo:lo + CHUNK],
                                                      bases_np[lo:lo + CHUNK], S,
                                                      kern.background, dev)
            ref = static_ray.static_ray_posed_plain(src_c, kern.ray_table, b32, globe, S, 10.0,
                                                    4.0, 1.0, exp, kern.background, k)
            e = int((out[lo:lo + CHUNK].long() - ref.long()).abs().max())
            require(torch.equal(out[lo:lo + CHUNK], ref),
                    f"PosedRemapKernel {kind} k={k} poses {lo}.. differ from the plain "
                    f"version (max {e})")
    static_k = static_ray.StaticRayPosedKernel(lens, globe, W, H, scale, platesize=S,
                                               device=dev)
    require(torch.equal(static_k(frames_dev, bases_np), outs_c["u8", 1]),
            "PosedRemapKernel differs from StaticRayPosedKernel on the same poses")
    del outs_c
    t_fused = cuda_ms(lambda: fused["u8", 1](frames_dev, bases_np), ITERS)
    t_static = cuda_ms(lambda: static_k(frames_dev, bases_np), ITERS)
    t_fused2 = cuda_ms(lambda: fused["u8", 1](frames_dev, bases_np), ITERS)
    table_ms = {k: cuda_ms(lambda k=k: static_ray.ray_table_from_lens(
        lens, scale * k, W // k, H // k, backend="torch", device=dev), ITERS) for k in (1, 2)}
    phase(7, f"PosedRemapKernel at 1080p B={POSED_B}, u8 and expanded, k = 1 and 2: bit-equal "
          f"to static_ray_posed_plain on the card and to StaticRayPosedKernel; a call (K7 + "
          f"K6, frames on the card) {t_fused:.4f} / {t_fused2:.4f} ms against "
          f"StaticRayPosedKernel's {t_static:.4f} ms; its float32 lens stage, once a kernel: "
          f"{table_ms[1]:.4f} ms at k=1, {table_ms[2]:.4f} ms at k=2")

    # ------------------------------------------------ d: the fused zoom sweep
    k9, k9_err = {}, 0
    ops_step = bb.resolve_ops_per_pixel(globe, rotate=False)
    step_rays = builder.lens_rays_torch(lens, torch.tensor(scales, dtype=torch.float64), W, H,
                                        dev)
    zero_bg = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    loop_sess = Session(W, H, device=dev, backend="torch")
    for kind, fr in (("u8", frame), ("expanded", frame_x)):
        fr_dev = torch.from_numpy(np.ascontiguousarray(fr)).to(dev)
        src_d = fr_dev.reshape(-1)
        args = (src_d, *step_rays, globe, S, 10.0, 4.0, 1.0, kind == "expanded", zero_bg)
        got = posed.sweep_remap(*args)
        require(torch.equal(got, outs_d[kind]), f"zoom_sweep_remap {kind} differs from "
                "sweep_remap on the same rays")
        seen = torch.zeros(src_d.numel(), dtype=torch.bool, device=dev)
        holes = False
        for n in range(SWEEP_STEPS):
            ref = posed.sweep_remap_plain(src_d, *(r[n:n + 1] for r in step_rays), globe, S,
                                          10.0, 4.0, 1.0, kind == "expanded", zero_bg)
            e = int((got[n:n + 1].long() - ref.long()).abs().max())
            require(torch.equal(got[n:n + 1], ref),
                    f"sweep_remap {kind} step {n} differs from its plain version (max {e})")
            k9_err = max(k9_err, e)
            lm = builder.rays_to_lensmap_torch(globe, *(r[n] for r in step_rays), S, 10.0,
                                               4.0, 1.0)
            idx = lm["flat_idx"].long()
            if kind == "expanded":
                idx = idx + torch.where((lm["tint"] != builder.TINT_NONE) & lm["valid"],
                                        6 * S * S, 0)
            seen[idx[lm["valid"]]] = True
            holes |= not bool(lm["valid"].all())
        texels = int(seen.sum())

        def loop(fr_dev=fr_dev, kind=kind):
            shots = []
            for fov in fovs:
                loop_sess.cmd(f"f_fov {fov}")
                shots.append(loop_sess.render(fr_dev, rubix=kind == "expanded"))
            return torch.stack(shots)

        require(torch.equal(loop(), got), f"zoom_sweep_remap {kind} differs from the per-step "
                "loop of Session(backend='torch')")
        ms, plain_ms = cuda_ms_pair(
            lambda: posed.sweep_remap(*args),
            lambda: posed.sweep_remap_plain(*args))
        lens_ms = cuda_ms(lambda: builder.lens_rays_torch(
            lens, torch.tensor(scales, dtype=torch.float64), W, H, dev), 3)
        walls = {"fused": [], "loop": []}
        for _ in range(3):
            for name, fn in (("fused", lambda: posed.zoom_sweep_remap(
                    lens, globe, scales, fr_dev, W, H, device=dev)), ("loop", loop)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        # each step's rays read and its screen written once, the source's
        # distinct texels once, the background once if any pixel shows it
        el = src_d.element_size()
        nbytes = (SWEEP_STEPS * npix * (bb.RESOLVE_BYTES_IN + el) + texels * el
                  + (npix * el if holes else 0))
        f32_ops = ops_step * npix * SWEEP_STEPS
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, f32_ops / F32_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        k9[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        phase(7, f"K9 sweep_remap {kind}, {SWEEP_STEPS} steps (f_fov {fovs[0]}..{fovs[-1]}) at "
              f"1080p: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {nbytes} bytes "
              f"({bytes_ms:.4f} ms: the rays, {texels} distinct texels, the screens"
              f"{', the background' if holes else '; every pixel valid, so no background'}), "
              f"{f32_ops} f32 operations "
              f"({ops_ms:.4f} ms); bound {bound:.4f} ms by {k9[kind]['bound_by']}, "
              f"{100 * bound / ms:.1f} % of it; bit-equal to its plain version step by step "
              f"and to the per-step loop; the lens stage over the ramp {lens_ms:.4f} ms; "
              f"zoom_sweep_remap end to end {', '.join(f'{w:.3f}' for w in walls['fused'])} ms "
              f"of wall clock against the per-step loop's "
              f"{', '.join(f'{w:.3f}' for w in walls['loop'])} ms")
        del got, args
    del step_rays, outs_d
    torch.cuda.empty_cache()

    # ------------------------------------------------ the rebuild, timed
    t0 = time.perf_counter()
    build_lensmap(lens, globe, scale, W, H, S)
    exact_now = time.perf_counter() - t0
    r = bb.rebuild_ms(lens, globe, scale, W, H, S, dev, iters=ITERS)
    rv = bb.rebuild_ms(lens, globe, scale, W, H, S, dev,
                       view_basis=view_basis_from_angles(10.0, 30.0, 0.0), iters=ITERS)
    # K8's own device time, from its CUPTI record: the events around the
    # wrapper read its host time (eight allocations and a compare beside the
    # launch), which is longer than the kernel
    rays_c = rays["cube"]
    _, dev_ms, _ = profiled(lambda: builder.lensmap_resolve(
        globe, *rays_c, S, 10, 4.0, 1.0, builder.IDENTITY_BASIS), ITERS, sync=False)
    k8_dev = sum(t for n_, t in dev_ms.items() if "lensmap_resolve" in n_)
    require(k8_dev > 0, "torch.profiler recorded no lensmap_resolve kernel")
    k8_bytes = npix * (bb.RESOLVE_BYTES_IN + bb.RESOLVE_BYTES_OUT) + 4 * ((S + 31) // 32) + 24
    k8_ops = bb.resolve_ops_per_pixel(globe) * npix
    k8_bytes_ms, k8_ops_ms = k8_bytes / HBM_BYTES_PER_S * 1e3, k8_ops / F32_OPS_PER_S * 1e3
    k8_bound = max(k8_bytes_ms, k8_ops_ms)
    k8_by = "bytes" if k8_bytes_ms >= k8_ops_ms else "operations"
    phase(7, f"warm float32 rebuild at 1080p (panini + cube): lens stage {r['lens_ms']:.4f} ms "
          f"+ K8 {r['resolve_ms']:.4f} ms (rotated view: {rv['lens_ms']:.4f} + "
          f"{rv['resolve_ms']:.4f} ms); build_lensmap(backend='torch') "
          f"{r['build_wall_ms']:.3f} ms of wall clock (rotated {rv['build_wall_ms']:.3f} ms); "
          f"the exact host build of this run {exact_now:.3f} s (phase 2: {exact_s:.3f} s), "
          f"{exact_now * 1e3 / r['build_wall_ms']:.0f}x; the first call {first_s * 1e3:.3f} ms")
    phase(7, f"K8 lensmap_resolve at 1080p: kernel {k8_dev:.4f} ms by the profiler's kernel "
          f"record, {r['resolve_ms']:.4f} ms a call by the events (the wrapper's host time), "
          f"plain {r['plain_ms']:.4f} ms; {k8_bytes} bytes "
          f"({k8_bytes_ms:.4f} ms), {k8_ops} f32 operations "
          f"({k8_ops_ms:.4f} ms); bound {k8_bound:.4f} ms by {k8_by}, "
          f"{100 * k8_bound / k8_dev:.1f} % of it by the kernel record "
          f"({100 * k8_bound / r['resolve_ms']:.1f} % by the events)")

    # a rebuild to the first frame, the tables left on the card; and what the
    # trip through the host that this saves would cost
    one = frames_dev[..., 0].contiguous()
    walls = []
    for fov in (170, 160, 150, 140):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.cmd(f"f_fov {fov}")
        sess.render(one)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    lm_np = sess._lensmap.to_numpy()
    down = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    remap.RemapKernel(lm_np, sess.palette, device=dev)
    torch.cuda.synchronize()
    up = (time.perf_counter() - t0) * 1e3
    sess.cmd("f_fov 180")
    phase(7, "Session(backend='torch'): one f_fov and the render of one frame, the tables "
          f"left on the card: {', '.join(f'{w:.3f}' for w in walls)} ms of wall clock; the "
          f"tables' copy to the host {down:.3f} ms and a RemapKernel's upload of them "
          f"{up:.3f} ms (the trip that a device-built LensMap does not take)")
    walls = []
    for cmd in ("setviewangles 10 30 0", "setviewangles 11 31 0", "setviewangles 12 32 0"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        auto.cmd(cmd)
        auto.render(frames_dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    phase(7, f"setviewangles and a render of the B={B_MAIN} batch on the card: "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms of wall clock")

    # ------------------------------------------------ three more lenses
    for name in ("mollweide", "winkeltripel", "fisheye1"):
        ln = lenses.get(name, globe)
        zoom = (ln.onload or "f_fov 180").split()
        sc = calc_scale(Zoom(zoom[0][2:], *map(int, zoom[1:])), ln, W, H)
        rays_l = builder.lens_rays_torch(ln, sc, W, H, dev)
        got = builder.lensmap_resolve(globe, *rays_l, S, 10, 4.0, 1.0, builder.IDENTITY_BASIS)
        want = builder.rays_to_lensmap_torch(
            globe, *rays_l, S, 10, 4.0, 1.0,
            view_basis=torch.from_numpy(builder.basis_f32(builder.IDENTITY_BASIS)).to(dev))
        k8_err = max(k8_err, tables_equal(got, want, name))
        valid = float(got["valid"].float().mean())
        del got, want
        rl = bb.rebuild_ms(ln, globe, sc, W, H, S, dev, iters=3)
        t0 = time.perf_counter()
        build_lensmap(ln, globe, sc, W, H, S)
        phase(7, f"{name} ({' '.join(zoom)}): lens stage {rl['lens_ms']:.4f} ms + K8 "
              f"{rl['resolve_ms']:.4f} ms, build_lensmap(backend='torch') "
              f"{rl['build_wall_ms']:.3f} ms of wall clock against the exact host build's "
              f"{time.perf_counter() - t0:.3f} s; K8 bit-equal on its rays; "
              f"{valid:.4f} of the pixels valid")
    # the lens stage's peak of live memory, in float32 planes a pixel: what
    # budget.py's SWEEP_LENS_PLANES must cover for a zoom step
    for name in ("panini", "winkeltripel"):
        ln = lenses.get(name, globe)
        planes = bb.lens_stage_peak_planes(ln, scale, W, H, dev)
        require(planes <= budget.SWEEP_LENS_PLANES,
                f"{name}'s lens stage holds {planes:.1f} float32 planes a pixel, more than "
                f"the sweep's chunking allows for ({budget.SWEEP_LENS_PLANES})")
        phase(7, f"{name}'s lens stage at 1080p holds at most {planes:.2f} float32 planes a "
              f"pixel live (torch.cuda.max_memory_allocated, its rays included); the sweep's "
              f"chunking allows {budget.SWEEP_LENS_PLANES}")

    rows = [
        # K8's time is its kernel record's: the events read the wrapper
        ("lensmap_resolve", "lensmap.cu", "blinky_tpu/lensmap/builder.py:165", k8_err,
         k8_dev, r["plain_ms"], k8_bound, k8_by, None, None),
        ("sweep_remap", "posed.cu", "blinky_tpu/kernels/posed.py:294", k9_err,
         k9["u8"]["ms"], k9["u8"]["plain_ms"], k9["u8"]["bound_ms"], k9["u8"]["bound_by"],
         None, None),
    ]
    return launches, rows



PANO_H, PANO_W, PANO_B = 2048, 4096, 128
EQ_W, EQ_H, EQ_S = 1280, 720, 720
EQ_CHUNK = 16  # lanes a plain-version check holds at once
AA_FACTOR = 2
MODES = ("compact", "fused", "faces")


def equirect_phase(dev, frames, frames_dev, kernels):
    """Phase 8: the 360-video path and the supersampled render.  Returns (the
    launches of K10, K11 and K12 in the path's run, their rows of the kernels
    line)."""
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import autobatch
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.bench.throughput import device_pano, run_equirect_throughput
    from blinky_tpu_torch.kernels import ingest, posed, remap, static_ray
    from blinky_tpu_torch.lensmap import builder

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    panos = device_pano(PANO_H, PANO_W, PANO_B, device=dev)
    torch.cuda.synchronize()
    phase(8, f"device_pano: {tuple(panos.shape)} {panos.dtype}, {panos.numel() * 4} bytes on "
          f"the card in {time.perf_counter() - t0:.3f} s")
    sess = Session(EQ_W, EQ_H, platesize=EQ_S, device=dev)
    aa_sess = Session(1920, 1080, device=dev)

    # ------------------------------------------------ the path, counted
    path_kernels = {"equirect_gather": ingest.equirect_gather,
                    "downsample_rgba": remap.downsample_rgba,
                    "tint_expand_rgba": remap.tint_expand_rgba}
    earlier = [posed.gather_posed, static_ray.static_ray_posed, posed.posed_layout,
               builder.lensmap_resolve, posed.sweep_remap]
    for fn in list(kernels.values()) + earlier + list(path_kernels.values()):
        fn.launches = 0
    ingest.equirect_gather.ring_launches = 0
    outs, by_mode = {}, {}
    for mode in MODES:
        n10, n1 = ingest.equirect_gather.launches, remap.remap_gather.launches
        for rubix in (False, True):
            if sess.rubix_enabled != rubix:
                sess.cmd("f_rubix")
            for bilinear in (True, False):
                t0 = time.perf_counter()
                out = sess.render_equirect(panos, bilinear=bilinear, mode=mode)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                if mode == MODES[0]:
                    outs[rubix, bilinear] = out
                    phase(8, f"render_equirect {mode} rubix={rubix} bilinear={bilinear}: "
                          f"{tuple(out.shape)} {out.dtype} in {first_s:.3f} s (with the "
                          "set-up of new tables)")
                else:
                    require(torch.equal(out.view(torch.int32),
                                        outs[rubix, bilinear].view(torch.int32)),
                            f"render_equirect {mode} rubix={rubix} bilinear={bilinear} "
                            f"differs from {MODES[0]}")
                del out
        by_mode[mode] = (ingest.equirect_gather.launches - n10,
                         remap.remap_gather.launches - n1)
    sess.cmd("f_rubix")  # off again
    aa = aa_sess.render_aa(frames_dev, factor=AA_FACTOR)
    faces = sess._equirect_cache[1](panos)  # nearest: the last tables the Session used
    expanded = remap.expand_frames_tinted_rgba(faces)
    sess.cmd("f_rubix")
    aa_rubix = sess.render_aa(expanded, factor=AA_FACTOR)
    sess.cmd("f_rubix")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in path_kernels.items()}
    k10_ring = ingest.equirect_gather.ring_launches
    phase(8, f"launches in the 360-video path's run: {launches}; (K10, K1) by mode: {by_mode}; "
          f"K1 in all: {remap.remap_gather.launches}; K10's ring (rows of "
          f"{remap.RING_MIN_ROW_BYTES} bytes and more, remap.ring_path) took {k10_ring} of its "
          f"{launches['equirect_gather']} launches")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the 360-video path")
    require(k10_ring == launches["equirect_gather"],
            f"K10 took its ring {k10_ring} times in {launches['equirect_gather']} launches, all "
            f"on {PANO_B * 4}-byte rows")
    for mode in MODES:
        require(by_mode[mode][0] == 4, f"{mode} launched K10 {by_mode[mode][0]} times, not 4")
        require(by_mode[mode][1] == (0 if mode == "fused" else 4),
                f"{mode} launched K1 {by_mode[mode][1]} times")
    phase(8, "compact, fused and faces bit-equal each other, plain and f_rubix, bilinear and "
          "nearest")

    # ------------------------------------------------ checks
    k = sess._kernel  # the RemapKernel of the renders above
    lm = sess.lensmap
    src = panos.view(torch.int32).reshape(-1, PANO_B)
    ingests = {b: ingest.EquirectIngest(PANO_H, PANO_W, EQ_S, globe=sess.globe, bilinear=b,
                                        device=dev) for b in (True, False)}
    tr, tm = k.tint_rgb_mask
    err = 0
    for (rubix, bilinear), out in outs.items():
        idx, w, pmask = ingests[bilinear].device_tables()
        bits = out.view(torch.int32)
        for lo in range(0, PANO_B, EQ_CHUNK):
            lanes = src[:, lo:lo + EQ_CHUNK].contiguous()
            f = ingest.equirect_gather_plain(lanes, idx, w if bilinear else None,
                                             plate_mask=pmask)
            ref = remap.remap_gather_plain(f, k.flat_idx, k.valid, k.background_rgba,
                                           **(dict(tint_rgb=tr, tint_mask=tm) if rubix else {}))
            got = bits[..., lo:lo + EQ_CHUNK].reshape(ref.shape)
            e = int((got.long() - ref.long()).abs().max())
            err = max(err, e)
            require(e == 0 and torch.equal(got, ref),
                    f"render_equirect rubix={rubix} bilinear={bilinear} lanes {lo}.. differ "
                    f"from the plain versions (max {e})")
            del lanes, f, ref
    phase(8, f"render_equirect at {PANO_W}x{PANO_H} -> {EQ_W}x{EQ_H} B={PANO_B}: every variant "
          "bit-equal to equirect_gather_plain + remap_gather_plain on the card")
    for b in (0, PANO_B - 1):
        pano = src[:, b].cpu().numpy().view(np.uint32).reshape(PANO_H, PANO_W)
        for bilinear in (True, False):
            host_faces = ingests[bilinear].host(pano)
            for rubix in (False, True):
                host = remap.host_remap(lm, host_faces, sess.palette, rubix=rubix)
                lane = outs[rubix, bilinear].view(torch.int32)[..., b].cpu().numpy()
                require(np.array_equal(lane.view(np.uint32), host),
                        f"render_equirect lane {b} rubix={rubix} bilinear={bilinear} differs "
                        "from EquirectIngest.host + host_remap")
    phase(8, f"lanes 0 and {PANO_B - 1} of every variant equal the all-host path "
          "(EquirectIngest.host, then host_remap)")
    del outs

    hi_sess = next(iter(aa_sess._aa_cache.values()))
    rgba = aa_sess._rgba_screen(frames_dev)
    hi = hi_sess.render(rgba)
    k11_ref = remap.downsample_rgba_plain(hi.view(torch.int32), AA_FACTOR)
    k11_err = int((aa.view(torch.int32).long() - k11_ref.long()).abs().max())
    require(torch.equal(aa.view(torch.int32), k11_ref),
            f"render_aa differs from downsample_rgba_plain of the hi-res render ({k11_err})")
    require(torch.equal(aa_sess.render_aa(frames_dev, factor=1).view(torch.int32),
                        aa_sess.render(rgba).view(torch.int32)),
            "render_aa(factor=1) differs from the plain u32 render")
    del k11_ref
    k12_ref = remap.tint_expand_rgba_plain(faces.view(torch.int32))
    k12_err = int((expanded.view(torch.int32).long() - k12_ref.long()).abs().max())
    require(torch.equal(expanded.view(torch.int32), k12_ref),
            f"expand_frames_tinted_rgba on the card differs from its plain version ({k12_err})")
    del k12_ref
    hi_rubix = next(iter(sess._aa_cache.values())).render(expanded, rubix=True)
    require(torch.equal(aa_rubix.view(torch.int32),
                        remap.downsample_rgba_plain(hi_rubix.view(torch.int32), AA_FACTOR)),
            "the rubix render_aa differs from downsample_rgba_plain of its hi-res render")
    host_x = remap.expand_frames_tinted_rgba(
        faces.view(torch.int32)[..., 0].cpu().numpy().view(np.uint32))
    require(np.array_equal(expanded.view(torch.int32)[..., 0].cpu().numpy().view(np.uint32),
                           host_x),
            "expand_frames_tinted_rgba on the card differs from its NumPy branch")
    phase(8, f"render_aa 1920x1080 factor {AA_FACTOR} B={B_MAIN} (K1 at 3840x2160, then K11) "
          f"bit-equal to downsample_rgba_plain; factor 1 equal to the plain u32 render; the "
          f"rubix render_aa of the faces' expansion (K12, {tuple(expanded.shape)}) bit-equal "
          "to the plain versions and the NumPy branch")
    del aa, aa_rubix, hi_rubix

    # ------------------------------------------------ K10's variants, timed
    def gather_bytes(idx, w, n_ops, keep=None):
        """The least bytes of one K10 call: the distinct pano rows the
        outputs that read any (keep) name, the tables, the per-output
        operands (n_ops bytes an output) and the output."""
        rows = int(torch.unique(idx if keep is None else idx[:, keep]).numel())
        n = idx.shape[1]
        tables = idx.numel() * 4 + (w.numel() * 4 if w is not None else 0)
        return rows, rows * PANO_B * 4 + tables + n * n_ops + n * PANO_B * 4

    chains = {b: (ingest.CompactEquirectChain(ingests[b], k),
                  ingest.EquirectScreenKernel(ingests[b], k)) for b in (True, False)}
    k10 = {}
    for bilinear in (True, False):
        tag = "bilinear" if bilinear else "nearest"
        compact, fused = chains[bilinear]
        full = ingests[bilinear].device_tables()
        sub = compact.sub.device_tables()
        variants = {
            f"faces, {tag}": (full[0], full[1], dict(plate_mask=full[2]), 4, full[2] != 0),
            f"compact, {tag}": (sub[0], sub[1], dict(plate_mask=sub[2]), 4, sub[2] != 0),
            f"fused, {tag}": (fused.idx, fused.w, dict(valid=k.valid, bg=k.background_rgba),
                              5, k.valid),
            f"fused + tint, {tag}": (fused.idx, fused.w,
                                     dict(valid=k.valid, bg=k.background_rgba, tint_rgb=tr,
                                          tint_mask=tm), 10, k.valid),
        }
        for name, (idx, w, kw, n_ops, keep) in variants.items():
            w = w if bilinear else None
            rows, nbytes = gather_bytes(idx, w, n_ops, keep)
            run = lambda idx=idx, w=w, kw=kw: ingest.equirect_gather(src, idx, w, **kw)  # noqa: E731
            ref = lambda idx=idx, w=w, kw=kw: ingest.equirect_gather_plain(  # noqa: E731
                src, idx, w, **kw)
            e = lane_chunked_err(run(), ref())
            err = max(err, e)
            require(e == 0, f"K10 {name} differs from its plain version (max {e})")
            ms, plain_ms = cuda_ms_pair(run, ref)
            reg = lambda run=run: register_path(ingest, run)  # noqa: E731
            require(torch.equal(reg(), run()), f"K10 {name}: the register path differs")
            ring_ms, reg_ms = cuda_ms_pair(run, reg)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            k10[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound)
            phase(8, f"K10 equirect_gather {name}, n={idx.shape[1]} B={PANO_B}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {rows} distinct pano rows, {nbytes} "
                  f"bytes, bound {bound:.4f} ms, {100 * bound / ms:.1f} % of it "
                  f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s); bit-equal; in turns its ring "
                  f"{ring_ms:.4f} ms ({100 * bound / ring_ms:.1f} %), its register path "
                  f"{reg_ms:.4f} ms ({100 * bound / reg_ms:.1f} %)")
            torch.cuda.empty_cache()
    idx_near = ingests[False].device_tables()[0]
    lib = lambda: torch.index_select(src, 0, idx_near[0])  # noqa: E731
    require(torch.equal(lib(), ingest.equirect_gather(src, idx_near)),
            "torch.index_select differs from K10 on the nearest tables")
    t_k, t_lib = cuda_ms_pair(lambda: ingest.equirect_gather(src, idx_near), lib)
    phase(8, f"K10 nearest without an epilogue (a row gather) {t_k:.4f} ms against its library "
          f"call torch.index_select(src, 0, idx) {t_lib:.4f} ms; the bilinear blend has no "
          "single library call")
    texels = int(chains[True][0].sub.texels.size)
    del chains

    # ------------------------------------------------ K11 and K12, timed
    hi_bits = hi.view(torch.int32)
    k11_bytes = hi_bits.numel() * 4 + hi_bits.numel() * 4 // (AA_FACTOR * AA_FACTOR)
    k11_ms, k11_plain = cuda_ms_pair(lambda: remap.downsample_rgba(hi_bits, AA_FACTOR),
                                     lambda: remap.downsample_rgba_plain(hi_bits, AA_FACTOR))
    k11_bound = k11_bytes / HBM_BYTES_PER_S * 1e3
    phase(8, f"K11 downsample_rgba {tuple(hi.shape)} by {AA_FACTOR}: kernel {k11_ms:.4f} ms, "
          f"plain {k11_plain:.4f} ms; {k11_bytes} bytes, bound {k11_bound:.4f} ms, "
          f"{100 * k11_bound / k11_ms:.1f} % of it ({k11_bytes / (k11_ms * 1e-3) / 1e9:.1f} "
          "GB/s); bit-equal")
    del hi, hi_bits, rgba
    torch.cuda.empty_cache()
    face_bits = faces.view(torch.int32)
    k12_bytes = face_bits.numel() * 4 + expanded.numel() * 4
    del expanded
    k12_ms, k12_plain = cuda_ms_pair(lambda: remap.tint_expand_rgba(face_bits),
                                     lambda: remap.tint_expand_rgba_plain(face_bits))
    k12_bound = k12_bytes / HBM_BYTES_PER_S * 1e3
    phase(8, f"K12 tint_expand_rgba {tuple(faces.shape)}: kernel {k12_ms:.4f} ms, plain "
          f"{k12_plain:.4f} ms; {k12_bytes} bytes, bound {k12_bound:.4f} ms, "
          f"{100 * k12_bound / k12_ms:.1f} % of it ({k12_bytes / (k12_ms * 1e-3) / 1e9:.1f} "
          "GB/s); bit-equal")
    del faces, face_bits
    torch.cuda.empty_cache()

    # ------------------------------------------------ end to end
    for bilinear in (True, False):
        for mode in MODES:
            r = run_equirect_throughput(
                PANO_H, PANO_W, EQ_S, EQ_W, EQ_H, iters=5, bilinear=bilinear,
                texel_compact=mode == "compact", fused=mode == "fused", device=dev, panos=panos)
            phase(8, f"render_equirect {mode}, panos on the card ({r['config']}): "
                  f"{r['ms_per_batch']:.4f} ms a batch, {r['fps']:.1f} panos/s")
    for batch in (1, 16, PANO_B):
        part = panos.view(torch.int32)[..., :batch].contiguous().view(torch.uint32)
        ms = cuda_ms(lambda: sess.render_equirect(part, mode="compact"), 5)
        phase(8, f"render_equirect compact bilinear at B={batch}: {ms:.4f} ms a batch, "
              f"{batch / (ms * 1e-3):.1f} panos/s, {ms / batch:.4f} ms a pano")
        del part
    aa_ms = cuda_ms(lambda: aa_sess.render_aa(frames_dev, factor=AA_FACTOR), 5)
    wall, dev_ms, busy = profiled(lambda: aa_sess.render_aa(frames_dev, factor=AA_FACTOR), 5)
    aa_k1 = sum(t for n_, t in dev_ms.items() if "remap_gather" in n_)
    aa_k11 = sum(t for n_, t in dev_ms.items() if "downsample" in n_)
    require(aa_k1 > 0 and aa_k11 > 0, "torch.profiler recorded no K1 or K11 under render_aa")
    # K1's bound inside render_aa: the hi-res lensmap's per-pixel operands
    # (index, mask, u32 background), the source rows it reads (clip rule) and
    # the u32 screens, each once
    k_hi = hi_sess._kernel
    n_hi = k_hi.flat_idx.numel()
    rows_hi = source_rows(k_hi.flat_idx, k_hi.valid, frames_dev[..., 0].numel(), False)
    aa_k1_bytes = n_hi * (4 + 1 + 4) + (rows_hi + n_hi) * B_MAIN * 4
    aa_k1_bound = aa_k1_bytes / HBM_BYTES_PER_S * 1e3
    src_hi = aa_sess._rgba_screen(frames_dev).view(torch.int32).reshape(-1, B_MAIN)
    aa_k1_plain = cuda_ms(lambda: remap.remap_gather_plain(
        src_hi, k_hi.flat_idx, k_hi.valid, k_hi.background_rgba), 3)
    del src_hi
    phase(8, f"K1 inside render_aa at 3840x2160 on the u32 source B={B_MAIN}: "
          f"{aa_k1:.4f} ms by its kernel record, plain {aa_k1_plain:.4f} ms; {rows_hi} "
          f"distinct source rows, {aa_k1_bytes} bytes, bound {aa_k1_bound:.4f} ms by bytes, "
          f"{100 * aa_k1_bound / aa_k1:.1f} % of it")
    phase(8, f"render_aa 1920x1080 factor {AA_FACTOR} B={B_MAIN}, frames on the card: "
          f"{aa_ms:.4f} ms a batch by the events; under the profiler {wall:.3f} ms a call, the "
          f"device busy {busy:.4f} ms = the palette decode {busy - aa_k1 - aa_k11:.4f} (every "
          f"record but the two kernels') + K1 at 3840x2160 on u32 {aa_k1:.4f} + K11 "
          f"{aa_k11:.4f} ms; device work by record: "
          + ", ".join(f"{n_[:40]} {t:.4f} ms" for n_, t in dev_ms.items()))
    fits = {mode: autobatch.equirect_feasible_batch(
        PANO_H, PANO_W, EQ_S, EQ_W, EQ_H, mode, True, texels, device=dev) for mode in MODES}
    phase(8, f"the lensmap reads {texels} of {6 * EQ_S * EQ_S} face texels; a pano lane keeps "
          + ", ".join(f"{autobatch.equirect_bytes_per_lane(PANO_H, PANO_W, EQ_S, EQ_W, EQ_H, m, texels)} "
                      f"bytes in {m}" for m in MODES)
          + f"; batches that fit the free memory now: {fits}")
    host_panos = panos.view(torch.int32).cpu().numpy().view(np.uint32)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        sess.render_equirect(host_panos, mode="compact")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    phase(8, f"render_equirect compact of a NumPy batch ({host_panos.nbytes} bytes copied from "
          f"pageable host memory to the card first), host wall clock: "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms")
    del host_panos, panos
    torch.cuda.empty_cache()

    main10 = k10["compact, bilinear"]
    rows = [
        ("equirect_gather", "ingest.cu", "blinky_tpu/kernels/ingest.py:133", err,
         main10["ms"], main10["plain_ms"], main10["bound_ms"], "bytes", None, None),
        ("downsample_rgba", "resample.cu", "blinky_tpu/kernels/remap.py:370", k11_err, k11_ms,
         k11_plain, k11_bound, "bytes", None, None),
        ("tint_expand_rgba", "resample.cu", "blinky_tpu/kernels/remap.py:402", k12_err, k12_ms,
         k12_plain, k12_bound, "bytes", None, None),
    ]
    return launches, rows


# phase 9: the twelve lenses that came with the forward rasterizer, in the
# order of blinky_tpu_torch.lenses.BUILTIN_LENSES
NEW_LENSES = ("debug", "eckert1", "eckert5", "gins8", "kavrayskiy7", "larrivee",
              "polyconic", "quincuncial", "sinusoidal", "wagner6", "winkel1", "winkel2")


def lenses_phase(dev, frames, frames_dev, kernels):
    """Phase 9: the last twelve lenses on the render, posed and device-builder
    paths.  Its launch counts are printed here; the kernels line keeps each
    kernel's launches in its own path's phase."""
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import builder as bb
    from blinky_tpu_torch.bench.posed import posed_poses
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.bench.throughput import device_pano
    from blinky_tpu_torch.camera import view_basis_from_angles
    from blinky_tpu_torch.kernels import ingest, posed, remap, static_ray
    from blinky_tpu_torch.lensmap import build_lensmap
    from blinky_tpu_torch.lensmap import builder

    S, H, W = 1080, 1080, 1920
    phase_t0 = time.perf_counter()
    poses = posed_poses(POSED_B)
    bases_np = posed.bases_from_pose_track(poses)
    torch.cuda.empty_cache()
    panos = device_pano(PANO_H, PANO_W, PANO_B, device=dev)  # phase 8's panos
    torch.cuda.synchronize()

    # ------------------------------------------------ the path, counted
    path_kernels = {"remap_gather": remap.remap_gather, "remap_lut": remap.remap_lut,
                    "posed_gather": posed.gather_posed,
                    "static_ray_posed": static_ray.static_ray_posed,
                    "posed_layout": posed.posed_layout,
                    "lensmap_resolve": builder.lensmap_resolve,
                    "equirect_gather": ingest.equirect_gather}
    for fn in list(kernels.values()) + list(path_kernels.values()):
        fn.launches = 0
    sessions, outs, build_s = {}, {}, {}
    for name in NEW_LENSES:                                   # a
        sess = Session(W, H, device=dev)
        t0 = time.perf_counter()
        sess.cmd(f"f_lens {name}")
        lm = sess.lensmap  # the exact host build (a forward lens: the rasterizer)
        build_s[name] = time.perf_counter() - t0
        outs[name] = sess.render(frames_dev)
        sessions[name] = sess
    eck = sessions["eckert1"]
    eck.cmd("f_rubix")                                        # b
    out_rubix = eck.render(frames_dev)
    eck.cmd("f_rubix")
    out_rgb = eck.render(frames_dev, decode_rgb=True)
    posed_outs, posed_kerns = {}, {}                          # c
    for k in (1, 2):
        posed_outs[k] = eck.render_posed(frames_dev, poses, render_scale=k)
        posed_kerns[k] = eck._posed_cache[1]
    exact = eck.render_posed(frames_dev[..., :2], poses[:2], exact=True)  # d
    view = Session(W, H, device=dev)                          # e
    view.cmd("f_lens eckert1; setviewangles 10 30 0")
    out_view = view.render(frames_dev)
    torch_sessions, torch_outs = {}, {}                       # f
    for name in ("quincuncial", "debug"):
        ts = Session(W, H, device=dev, backend="torch")
        ts.cmd(f"f_lens {name}")
        torch_outs[name] = ts.render(frames_dev)
        torch_sessions[name] = ts
    eq = Session(EQ_W, EQ_H, platesize=EQ_S, device=dev)      # g
    eq.cmd("f_lens eckert1")
    eq_outs = {mode: eq.render_equirect(panos, mode=mode) for mode in ("compact", "fused")}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in path_kernels.items()}
    run_s = time.perf_counter() - phase_t0
    phase(9, f"launches in the last twelve lenses' run (a: Session.render of the B={B_MAIN} "
          f"batch for each of {len(NEW_LENSES)} lenses, b: eckert1 f_rubix and decode_rgb, "
          f"c: eckert1 render_posed B={POSED_B} k = 1 and 2, d: two exact poses, e: eckert1 "
          f"after setviewangles 10 30 0, f: quincuncial and debug on Session(backend='torch'), "
          f"g: eckert1 render_equirect compact and fused): {launches}; {run_s:.3f} s")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the last twelve lenses' path")

    # ------------------------------------------------ a and b: the renders
    src = frames_dev.reshape(-1, B_MAIN)
    for name in NEW_LENSES:
        sess, out = sessions[name], outs[name]
        k = sess._kernel
        lm = sess.lensmap
        plain = remap.remap_gather_plain(src, k.flat_idx, k.valid, k.background,
                                         fill=True).reshape(out.shape)
        e = int((out.int() - plain.int()).abs().max())
        require(torch.equal(out, plain), f"{name}: render differs from the plain version ({e})")
        for b in (0, B_MAIN - 1):
            require(np.array_equal(out[..., b].cpu().numpy(), sess.render_host(frames[..., b])),
                    f"{name}: render frame {b} differs from host_remap")
        # K1's bound as phase 2 counts it: the per-pixel operands, the source
        # rows this lensmap reads, the screens
        n = k.flat_idx.numel()
        nbytes = n * 6 + (source_rows(k.flat_idx, k.valid, src.shape[0], True) + n) * B_MAIN
        k1_ms = cuda_ms(lambda: remap.remap_gather(src, k.flat_idx, k.valid, k.background,
                                                   fill=True), ITERS)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        phase(9, f"{name} ({sess.lens.map_type}, {sess.zoom.command()}): exact host build "
              f"{build_s[name]:.3f} s"
              + (" (the forward rasterizer, native quad fill)" if sess.lens.map_type == "forward"
                 else "")
              + f"; {float(lm.valid.mean()):.6f} of the pixels valid; plates_used "
              f"{lm.plates_used.astype(int).tolist()}; K1 render bit-equal to its plain "
              f"version and to host_remap for frames 0 and {B_MAIN - 1}; K1 {k1_ms:.4f} ms, "
              f"{nbytes} bytes, bound {bound_ms:.4f} ms, {100 * bound_ms / k1_ms:.1f} % of it")
        del plain
    k = eck._kernel
    for what, got, ref, kw in (
            ("f_rubix", out_rubix, remap.remap_lut_plain(src, k.flat_idx, k.valid, k.tint,
                                                         k.background, k.tint_lut), {}),
            ("decode_rgb", out_rgb, remap.remap_lut_plain(src, k.flat_idx, k.valid, k.tint,
                                                          k.background, None, k.rgb_lut),
             dict(decode_rgb=True))):
        require(torch.equal(got, ref.reshape(got.shape)),
                f"eckert1 {what}: render differs from K2's plain version")
        host = eck.render_host(frames[..., 0], rubix=what == "f_rubix", **kw)
        dev0 = got[..., 0, :] if kw else got[..., 0]
        require(np.array_equal(dev0.cpu().numpy(), host),
                f"eckert1 {what}: frame 0 differs from host_remap")
        del ref
    phase(9, "eckert1 f_rubix and decode_rgb renders (K2) bit-equal their plain versions and "
          "host_remap for frame 0")
    del out_rubix, out_rgb

    # ------------------------------------------------ c and d: the posed path
    scale = posed_kerns[1].scale
    for k in (1, 2):
        kern, out = posed_kerns[k], posed_outs[k]
        require(kern.ray_table.source == "lensmap",
                f"eckert1 k={k}: the ray table is not the rasterized lensmap's")
        for lo in range(0, POSED_B, CHUNK):
            src_c, b32, expanded = posed.prep_posed_inputs(
                frames_dev[..., lo:lo + CHUNK], bases_np[lo:lo + CHUNK], S,
                kern.background, dev)
            ref = static_ray.static_ray_posed_plain(src_c, kern.ray_table, b32, kern.globe, S,
                                                    kern.numcells, kern.cell_size,
                                                    kern.pad_size, expanded, kern.background, k)
            e = int((out[lo:lo + CHUNK].long() - ref.long()).abs().max())
            require(torch.equal(out[lo:lo + CHUNK], ref),
                    f"eckert1 render_posed k={k} poses {lo}.. differ from "
                    f"static_ray_posed_plain (max {e})")
    kern = posed_kerns[1]
    src_p, bases_p, expanded = posed.prep_posed_inputs(frames_dev, bases_np, S,
                                                       kern.background, dev)
    k6_ms = cuda_ms(lambda: static_ray.static_ray_posed(
        src_p, kern.ray_table, bases_p, kern.globe, S, kern.numcells, kern.cell_size,
        kern.pad_size, expanded, kern.background, 1), ITERS)
    del src_p
    ident = float((posed_outs[1][0] != outs["eckert1"][..., 0]).float().mean())
    phase(9, f"eckert1 render_posed at 1080p B={POSED_B}, u8, render_scale 1 and 2: the ray "
          "table from the rasterized lensmap (k=1: the session's static one; k=2: a "
          f"rasterization at {W // 2}x{H // 2}), K7 and K6 bit-equal to static_ray_posed_plain "
          "on the "
          f"card; K6 at k=1 {k6_ms:.4f} ms on this table; the identity pose differs from "
          f"the static render on {ident:.6f} of the pixels (plate seams: max-dot "
          "re-resolution against the rasterizer's ownership)")
    require(ident <= 0.02, f"eckert1's identity pose differs from the static render at {ident}")
    exact_s = []
    for b in range(2):
        t0 = time.perf_counter()
        lm_b = build_lensmap(eck.lens, eck.globe, scale, W, H, S,
                             view_basis=tuple(bases_np[b]))
        exact_s.append(time.perf_counter() - t0)
        host = remap.host_remap(lm_b, frames[..., b], eck.palette)
        require(np.array_equal(exact[b].cpu().numpy(), host),
                f"eckert1 render_posed(exact=True) pose {b} differs from host_remap")
    phase(9, "eckert1 render_posed(exact=True) of two poses (K5) bit-equal host_remap of the "
          "host rasterization at each pose's basis ("
          + ", ".join(f"{t:.3f}" for t in exact_s) + " s a rasterization)")
    del posed_outs, exact

    # ------------------------------------------------ e: a rotated view under "auto"
    require(isinstance(view._lensmap.flat_idx, np.ndarray),
            "eckert1 after setviewangles did not take the host rasterizer")
    vb = view_basis_from_angles(10.0, 30.0, 0.0)
    t0 = time.perf_counter()
    lm_v = build_lensmap(view.lens, view.globe, view._lensmap.scale, W, H, S, view_basis=vb)
    view_s = time.perf_counter() - t0
    require(np.array_equal(lm_v.flat_idx, view._lensmap.flat_idx),
            "eckert1 after setviewangles: the Session's table differs from build_lensmap")
    kv = view._kernel
    require(torch.equal(out_view, remap.remap_gather_plain(
        src, kv.flat_idx, kv.valid, kv.background, fill=True).reshape(out_view.shape)),
        "eckert1 after setviewangles: render differs from the plain version")
    for b in (0, B_MAIN - 1):
        require(np.array_equal(out_view[..., b].cpu().numpy(),
                               remap.host_remap(lm_v, frames[..., b], view.palette)),
                f"eckert1 after setviewangles: frame {b} differs from host_remap")
    moved = float((lm_v.flat_idx != sessions["eckert1"].lensmap.flat_idx).mean())
    phase(9, f"eckert1 after setviewangles 10 30 0 under 'auto': the host rasterizer with the "
          f"view basis ({view_s:.3f} s), then K1, bit-equal to the plain version and to "
          f"host_remap for frames 0 and {B_MAIN - 1}; the rotation moved {moved:.4f} of the "
          "lensmap's indices")
    del out_view, outs

    # ------------------------------------------------ f: the float32 device builder
    ident_basis = torch.from_numpy(builder.basis_f32(builder.IDENTITY_BASIS)).to(dev)
    fields = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
    for name, ts in torch_sessions.items():
        lm_t = ts._lensmap
        require(isinstance(lm_t.flat_idx, torch.Tensor),
                f"{name} on Session(backend='torch') did not build on the card")
        sc = lm_t.scale
        rays = builder.lens_rays_torch(ts.lens, sc, W, H, dev)
        got = builder.lensmap_resolve(ts.globe, *rays, S, 10, 4.0, 1.0, builder.IDENTITY_BASIS)
        want = builder.rays_to_lensmap_torch(ts.globe, *rays, S, 10, 4.0, 1.0,
                                             view_basis=ident_basis)
        for f in fields:
            require(torch.equal(got[f], want[f]),
                    f"{name}: lensmap_resolve's {f} differs from rays_to_lensmap_torch")
            require(torch.equal(got[f], getattr(lm_t, f)),
                    f"{name}: the Session's float32 table differs from K8 on the same rays")
        del got, want
        out = torch_outs[name]
        require(torch.equal(out, remap.remap_gather_plain(
            src, lm_t.flat_idx.reshape(-1), lm_t.valid.reshape(-1),
            torch.zeros(H * W, dtype=torch.uint8, device=dev), fill=True).reshape(out.shape)),
            f"{name} on Session(backend='torch'): render differs from the plain version")
        exact_lm = sessions[name].lensmap
        f32 = lm_t.to_numpy()
        share = float((f32.flat_idx != exact_lm.flat_idx).mean())
        _, dev_ms, _ = profiled(lambda: builder.lensmap_resolve(
            ts.globe, *rays, S, 10, 4.0, 1.0, builder.IDENTITY_BASIS), ITERS, sync=False)
        k8_dev = sum(t for n_, t in dev_ms.items() if "lensmap_resolve" in n_)
        require(k8_dev > 0, "torch.profiler recorded no lensmap_resolve kernel")
        rl = bb.rebuild_ms(ts.lens, ts.globe, sc, W, H, S, dev, iters=3)
        phase(9, f"{name} on Session(backend='torch'): lens stage {rl['lens_ms']:.4f} ms, K8 "
              f"{k8_dev:.4f} ms by its kernel record ({rl['resolve_ms']:.4f} ms a call by the "
              f"events), build_lensmap(backend='torch') {rl['build_wall_ms']:.3f} ms of wall "
              f"clock against the exact host build's {build_s[name]:.3f} s; K8 bit-equal to "
              f"rays_to_lensmap_torch on the same rays and the render to the plain version; "
              f"the float32 build differs from the exact build on {share:.6f} of the pixels")
        del rays
    del torch_outs

    # ------------------------------------------------ g: render_equirect
    require(torch.equal(eq_outs["compact"].view(torch.int32), eq_outs["fused"].view(torch.int32)),
            "eckert1 render_equirect: compact differs from fused")
    bits = panos.view(torch.int32).reshape(-1, PANO_B)
    ing = ingest.EquirectIngest(PANO_H, PANO_W, EQ_S, globe=eq.globe, bilinear=True, device=dev)
    for b in (0, PANO_B - 1):
        pano = bits[:, b].cpu().numpy().view(np.uint32).reshape(PANO_H, PANO_W)
        host = remap.host_remap(eq.lensmap, ing.host(pano), eq.palette)
        for mode, out in eq_outs.items():
            lane = out.view(torch.int32)[..., b].cpu().numpy().view(np.uint32)
            require(np.array_equal(lane, host),
                    f"eckert1 render_equirect {mode} lane {b} differs from the all-host path")
    eq_ms = {mode: cuda_ms(lambda mode=mode: eq.render_equirect(panos, mode=mode), ITERS)
             for mode in ("compact", "fused")}
    phase(9, f"eckert1 render_equirect at {PANO_W}x{PANO_H} -> {EQ_W}x{EQ_H} B={PANO_B}, "
          f"compact (K10, K1) and fused (K10): equal to each other, and lanes 0 and "
          f"{PANO_B - 1} to EquirectIngest.host + host_remap; a batch, panos on the card: "
          f"compact {eq_ms['compact']:.4f} ms, fused {eq_ms['fused']:.4f} ms; phase 9 took "
          f"{time.perf_counter() - phase_t0:.3f} s")
    del eq_outs, panos, bits
    torch.cuda.empty_cache()


LUA_SWEEP_STEPS = 8
# the script-globe kernels before their redesign (K13 a pixel and pose a
# thread; K6's mode 2 reading its plates a byte at a time before each
# resolve), measured by this script's phase 10 on an NVIDIA H100 80GB HBM3 at
# 700 W, printed beside today's for comparison
BEFORE_REDESIGN = "K13 1.0730 ms, K6 mode 2 0.7277 ms, the resolver over the batch 9.9-14.2 ms"


def lua_phase(dev, frames, frames_dev, kernels):
    """Phase 10: the Lua drop-ins (blinky_tpu_torch/bench/lua_drop_ins.py,
    written to a temporary directory for lens_dirs and globe_dirs).  Returns
    (the launches of K8, K6 and K9 in resolver mode 2 and of K13 in the
    phase's run, their rows of the kernels line)."""
    import shutil
    import tempfile

    from blinky_tpu_torch import globes, lua_vector
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import builder as bb
    from blinky_tpu_torch.bench import lua_drop_ins
    from blinky_tpu_torch.bench import posed as bench_posed
    from blinky_tpu_torch.bench.posed import posed_poses
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.camera import view_basis_from_angles
    from blinky_tpu_torch.kernels import _build, posed, remap, script_tape, static_ray
    from blinky_tpu_torch.lensmap import build_lensmap
    from blinky_tpu_torch.lensmap import builder
    from blinky_tpu_torch.palette import MAX_PLATES, rgba_lut

    S, H, W = 1080, 1080, 1920
    npix = H * W
    phase_t0 = time.perf_counter()
    poses = posed_poses(POSED_B)
    bases_np = posed.bases_from_pose_track(poses)
    tmp = tempfile.mkdtemp(prefix="blinky_lua_")
    try:
        d = lua_drop_ins.write_scripts(tmp)

        def session(*lines, **kw):
            s = Session(W, H, device=dev, lens_dirs=[d], globe_dirs=[d], **kw)
            for line in lines:
                s.cmd(line)
            return s

        # ------------------------------------------------ the path, counted
        path_kernels = {"remap_gather": remap.remap_gather, "posed_gather": posed.gather_posed,
                        "static_ray_posed": static_ray.static_ray_posed,
                        "posed_layout": posed.posed_layout,
                        "lensmap_resolve": builder.lensmap_resolve,
                        "sweep_remap": posed.sweep_remap, "rotate_rays": builder.rotate_rays,
                        "script_tape": script_tape.script_tape}
        given = (builder.lensmap_resolve, static_ray.static_ray_posed, posed.sweep_remap)
        for fn in list(kernels.values()) + list(path_kernels.values()):
            fn.launches = 0
        for fn in given:
            fn.given_launches = 0
        t = {}
        pan_t = session("f_lens lpanini", backend="torch")             # a
        out_a = pan_t.render(frames_dev)
        pan_v = session("f_lens lpanini", "setviewangles 10 30 0")      # b
        out_b = pan_v.render(frames_dev)
        pan_p = session("f_lens lpanini")                               # c
        posed_c = {k: pan_p.render_posed(frames_dev, poses, render_scale=k) for k in (1, 2)}
        newton = session("f_lens lnewton", backend="torch")             # d
        out_d = newton.render(frames_dev)
        fast_t = session("f_globe lfast", backend="torch")              # e
        out_e = fast_t.render(frames_dev)
        fast_p = session("f_globe lfast")                               # f
        posed_f = fast_p.render_posed(frames_dev, poses)
        fovs = bb.sweep_fovs(steps=LUA_SWEEP_STEPS)                      # g
        scales = bb.sweep_scales(fast_t.lens, W, H, fovs)
        sweep_g = posed.zoom_sweep_remap(fast_t.lens, fast_t.globe, scales, frames[..., 0], W,
                                         H, device=dev)
        scat = session("f_lens scat")                                   # h
        t0 = time.perf_counter()
        scat_lm = scat.lensmap
        t["scat exact"] = time.perf_counter() - t0
        out_h = scat.render(frames_dev)
        t0 = time.perf_counter()
        posed_h = scat.render_posed(frames_dev, poses, render_scale=2)
        t["scat posed"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        exact_h = scat.render_posed(frames_dev[..., :1], poses[:1], render_scale=2, exact=True)
        t["scat exact pose"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in path_kernels.items()}
        launches.update({f"{fn.__name__}_given": fn.given_launches for fn in given})
        phase(10, f"launches in the Lua drop-ins' run (a: lpanini on Session(backend='torch'), "
              f"b: lpanini after setviewangles 10 30 0, c: lpanini render_posed B={POSED_B} "
              f"k = 1 and 2, d: lnewton on Session(backend='torch'), e: lfast on "
              f"Session(backend='torch'), f: lfast render_posed B={POSED_B}, g: lfast "
              f"zoom_sweep_remap of {LUA_SWEEP_STEPS} steps, h: scat's exact host build, its "
              f"render, render_posed k=2 and one exact pose at k=2): {launches}; "
              f"{time.perf_counter() - phase_t0:.3f} s")
        for name, n in launches.items():
            require(n >= 1, f"{name} was not launched by the Lua drop-ins' path")
        require(pan_t.lens.jittable and newton.lens.jittable and fast_t.globe.jittable
                and not scat.lens.jittable, "a drop-in's jittable is not as its script says")
        require(pan_v._resolved_backend() == "torch" and scat._resolved_backend() == "numpy",
                "a drop-in did not take its builder")

        # ------------------------------------------------ a-c: lpanini = panini
        def differs(got, want, what):
            share = float((got != want).float().mean())
            require(share == 0.0, f"{what} differs from the built-in's on {share:.6f} of the "
                    "pixels")

        ref_t = Session(W, H, device=dev, backend="torch")
        differs(out_a, ref_t.render(frames_dev), "lpanini on Session(backend='torch')")
        ref_v = Session(W, H, device=dev)
        ref_v.cmd("setviewangles 10 30 0")
        differs(out_b, ref_v.render(frames_dev), "lpanini after setviewangles 10 30 0")
        ref_p = Session(W, H, device=dev)
        for k in (1, 2):
            differs(posed_c[k], ref_p.render_posed(frames_dev, poses, render_scale=k),
                    f"lpanini render_posed k={k}")
        del posed_c, ref_v
        lens_ms = {}
        for name, lens, globe in (("lpanini", pan_t.lens, pan_t.globe),
                                  ("panini", ref_t.lens, ref_t.globe),
                                  ("lnewton", newton.lens, newton.globe)):
            sc = calc_scale_of(lens, W, H)
            lens_ms[name] = bb.rebuild_ms(lens, globe, sc, W, H, S, dev, iters=3)
        phase(10, "lpanini's screens (Session(backend='torch'), setviewangles 10 30 0, "
              f"render_posed of {POSED_B} poses at k = 1 and 2) bit-equal the built-in "
              "panini's on the card; the lens stage at 1080p: lpanini "
              f"{lens_ms['lpanini']['lens_ms']:.4f} ms, the built-in panini "
              f"{lens_ms['panini']['lens_ms']:.4f} ms, lnewton "
              f"{lens_ms['lnewton']['lens_ms']:.4f} ms (CUDA events around the call: the "
              "script's host time included); build_lensmap(backend='torch') "
              f"{lens_ms['lpanini']['build_wall_ms']:.3f} / "
              f"{lens_ms['panini']['build_wall_ms']:.3f} / "
              f"{lens_ms['lnewton']['build_wall_ms']:.3f} ms of wall clock")

        # ------------------------------------------------ d: lnewton, the masked loop
        lm_d = newton._lensmap
        rays_d = builder.lens_rays_torch(newton.lens, lm_d.scale, W, H, dev)
        ident = torch.from_numpy(builder.basis_f32(builder.IDENTITY_BASIS)).to(dev)
        want = builder.rays_to_lensmap_torch(newton.globe, *rays_d, S, 10, 4.0, 1.0,
                                             view_basis=ident)
        for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
            require(torch.equal(getattr(lm_d, f), want[f]),
                    f"lnewton: the Session's table differs from K8's plain version in {f}")
        t0 = time.perf_counter()
        exact_d = build_lensmap(newton.lens, newton.globe, lm_d.scale, W, H, S)
        exact_d_s = time.perf_counter() - t0
        share_d = float((lm_d.flat_idx.cpu().numpy() != exact_d.flat_idx).mean())
        require(share_d <= 0.15, f"lnewton's float32 build is off the exact one on {share_d} "
                "of the pixels, past the float32 boundary tolerance")
        src = frames_dev.reshape(-1, B_MAIN)
        k = newton._kernel
        require(torch.equal(out_d, remap.remap_gather_plain(
            src, k.flat_idx, k.valid, k.background, fill=True).reshape(out_d.shape)),
            "lnewton: render differs from the plain version")
        iters = []
        orig = lua_vector.VectorInterpreter._any_alive

        def counting(alive):
            go = orig(alive)
            iters.append(go)
            return go

        lua_vector.VectorInterpreter._any_alive = staticmethod(counting)
        try:
            builder.lens_rays_torch(newton.lens, lm_d.scale, W, H, dev)
        finally:
            lua_vector.VectorInterpreter._any_alive = staticmethod(orig)
        phase(10, f"lnewton on the card: its masked repeat-until loop ran {sum(iters) + 1} "
              f"iterations at 1080p (the cap is {lua_vector.VectorInterpreter.TRACE_LOOP_CAP}); "
              "the Session's table bit-equal to K8's plain version on the lens stage's rays, "
              f"the render to K1's plain version; the float32 build differs from the exact "
              f"host build ({exact_d_s:.3f} s) on {share_d:.6f} of the pixels")
        del rays_d, want

        # ------------------------------------------------ e: lfast, K13 and K8 mode 2
        g_lua, g_ref = fast_t.globe, globes.get("fast")
        lens_e = fast_t.lens
        rays_e = builder.lens_rays_torch(lens_e, fast_t._lensmap.scale, W, H, dev)
        k8_err, share_fast = 0, 0.0
        for vname, angles in VIEWS.items():
            vb = builder.IDENTITY_BASIS if angles is None else view_basis_from_angles(*angles)
            vbt = torch.from_numpy(builder.basis_f32(vb)).to(dev)
            rot = builder.rotate_rays(*rays_e[:3], vbt[None])
            rot_plain = builder.rotate_normalize_torch(*rays_e[:3], vbt[None])
            for a, b in zip(rot, rot_plain):
                require(torch.equal(a, b), f"rotate_rays ({vname}) differs from its plain version")
            plate = builder.script_plates(g_lua, *(r[0] for r in rot))
            got = builder.lensmap_resolve(g_lua, *rays_e, S, 10, 4.0, 1.0, vb, plate=plate)
            want = builder.rays_to_lensmap_torch(g_lua, *rays_e, S, 10, 4.0, 1.0,
                                                 view_basis=vbt, plate=plate)
            ref = builder.lensmap_resolve(g_ref, *rays_e, S, 10, 4.0, 1.0, vb)
            for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
                e = int((got[f].long() - want[f].long()).abs().max())
                require(torch.equal(got[f], want[f]),
                        f"lensmap_resolve mode 2 ({vname}): {f} differs from its plain "
                        f"version (max {e})")
                k8_err = max(k8_err, e)
            share_fast = max(share_fast, float((got["flat_idx"] != ref["flat_idx"])
                                               .float().mean()))
            del rot, rot_plain, got, want, ref
        k = fast_t._kernel
        require(torch.equal(out_e, remap.remap_gather_plain(
            src, k.flat_idx, k.valid, k.background, fill=True).reshape(out_e.shape)),
            "lfast: render differs from K1's plain version")
        screen_fast = float((out_e != _fast_screen(W, H, dev, frames_dev)).float().mean())
        plate_e = builder.script_plates(g_lua, *(r[0] for r in builder.rotate_rays(
            *rays_e[:3], ident[None])))
        def k8_launch_ms(globe, plate, iters=50):
            """K8's ms a launch on lfast's rays: CUDA events around *iters*
            back-to-back launches of its C entry point, whose host time
            (a ctypes call) is under the kernel's, unlike the wrapper's.
            (torch.profiler's kernel records, phase 7's measure, came back
            short or empty late in a full run on an NVIDIA H100.)"""
            consts, nplates, resolver, fast_dist, fast_half = builder.resolver_args(globe)
            basis = builder.basis_f32(builder.IDENTITY_BASIS)
            lines = builder.grid_line_words(S, 10.0, 4.0, 1.0, dev)
            with _build.on_device(dev) as stream:
                outs = [torch.empty(npix, dtype=dt, device=dev) for dt in (
                    torch.int32, torch.int32, torch.int32, torch.bool, torch.uint8,
                    torch.int32)]
                used = torch.zeros(6, dtype=torch.int32, device=dev)
                args = ([t.data_ptr() for t in rays_e] + [npix, basis.ctypes.data,
                        consts.ctypes.data, nplates, resolver, fast_dist, fast_half,
                        None if plate is None else plate.data_ptr(), lines.data_ptr(), S]
                        + [t.data_ptr() for t in outs] + [used.data_ptr(), stream])
                lib = _build.library()

                def launch():
                    _build.check(lib.blinky_lensmap_resolve(*args), "lensmap_resolve")

                return cuda_ms(launch, iters)

        k8_dev, k8_fast = k8_launch_ms(g_lua, plate_e), k8_launch_ms(g_ref, None)
        k8_plain = cuda_ms(lambda: builder.rays_to_lensmap_torch(
            g_lua, *rays_e, S, 10, 4.0, 1.0, view_basis=ident, plate=plate_e), 3)
        k8_bytes = (npix * (bb.RESOLVE_BYTES_IN + bb.GIVEN_PLATE_BYTES + bb.RESOLVE_BYTES_OUT)
                    + 4 * ((S + 31) // 32) + 24)
        k8_ops = bb.resolve_ops_per_pixel(g_lua) * npix
        k8_bytes_ms, k8_ops_ms = k8_bytes / HBM_BYTES_PER_S * 1e3, k8_ops / F32_OPS_PER_S * 1e3
        k8_bound = max(k8_bytes_ms, k8_ops_ms)
        k8_by = "bytes" if k8_bytes_ms >= k8_ops_ms else "operations"
        resolver_e = cuda_ms(lambda: builder.script_plates(g_lua, *rays_e[:3]), 3)
        phase(10, f"lfast on the card: K13 bit-equal to its plain version and K8 in mode 2 "
              f"to rays_to_lensmap_torch on the same rays and plates, the identity and two "
              f"rotated bases; K8 mode 2's tables differ from K8 on the built-in fast globe on "
              f"{share_fast:.6f} of the pixels, the screen from the built-in fast's on "
              f"{screen_fast:.6f}; the render bit-equal to K1's plain version.  K8 mode 2 at "
              f"1080p: kernel {k8_dev:.4f} ms (events around its entry point's launches), plain "
              f"{k8_plain:.4f} ms; {k8_bytes} bytes ({k8_bytes_ms:.4f} ms), {k8_ops} f32 "
              f"operations ({k8_ops_ms:.4f} ms); bound {k8_bound:.4f} ms by {k8_by}, "
              f"{100 * k8_bound / k8_dev:.1f} % of it (K8 on the built-in fast globe, resolver "
              f"1, on the same rays: {k8_fast:.4f} ms); the script resolver on one 1080p "
              f"screen of rays {resolver_e:.4f} ms")
        del rays_e

        # ------------------------------------------------ f: lfast posed, K13 and K6 mode 2
        kern = fast_p._posed_cache[1]
        table = kern.ray_table
        src_p, bases_p, expanded = posed.prep_posed_inputs(frames_dev, bases_np, S,
                                                           kern.background, dev)
        plates_f = static_ray.script_pose_plates(table, bases_p, g_lua)
        k6_err = 0
        for lo in range(0, POSED_B, CHUNK):
            sl = slice(lo, lo + CHUNK)
            rot = builder.rotate_rays(table.vx, table.vy, table.vz, bases_p[sl])
            rot_plain = builder.rotate_normalize_torch(table.vx, table.vy, table.vz,
                                                       bases_p[sl])
            for a, b in zip(rot, rot_plain):
                require(torch.equal(a, b), f"rotate_rays poses {lo}.. differ from the plain "
                        "version")
            require(torch.equal(plates_f[sl], builder.script_plates(g_lua, *rot).clamp(
                -1, MAX_PLATES).to(torch.int8)), f"lfast's plates of poses {lo}.. (K14) differ "
                "from the evaluator's")
            del rot, rot_plain
            ref = static_ray.static_ray_posed_plain(
                src_p[sl], table, bases_p[sl], g_lua, S, kern.numcells, kern.cell_size,
                kern.pad_size, expanded, kern.background, 1, plates=plates_f[sl])
            e = int((posed_f[sl].long() - ref.long()).abs().max())
            require(torch.equal(posed_f[sl], ref), f"lfast render_posed poses {lo}.. differ "
                    f"from static_ray_posed_plain on the same plates (max {e})")
            k6_err = max(k6_err, e)
        ref_f = Session(W, H, device=dev)
        ref_f.cmd("f_globe fast")
        posed_share = float((posed_f != ref_f.render_posed(frames_dev, poses)).float().mean())
        args6 = (src_p, table, bases_p, g_lua, S, kern.numcells, kern.cell_size,
                 kern.pad_size, expanded, kern.background, 1)
        # by the events alone: at 0.6-0.9 ms a call they read K6's kernel
        # record (phase 6), while late in a full run on an NVIDIA H100
        # torch.profiler's records of this call came back empty
        k6_ms, k6_plain = cuda_ms_pair(
            lambda: static_ray.static_ray_posed(*args6, plates=plates_f),
            lambda: static_ray.static_ray_posed_plain(*args6, plates=plates_f))
        torch.cuda.empty_cache()

        def mode2_bound(npix_b, npix_s, texels, el):
            """K6 mode 2's bytes (the rays, bases, plates, the distinct
            texels, background and screens of el bytes), operations and
            bound for npix_b build and npix_s screen pixels a pose."""
            nbytes = (npix_b * 13 + POSED_B * 36 + POSED_B * npix_b
                      + (texels + npix_s + POSED_B * npix_s) * el)
            ops = bb.resolve_ops_per_pixel(g_lua) * npix_b * POSED_B
            b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            return nbytes, ops, max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"

        def distinct_texels(table, plates):
            """The distinct texels the posed batch reads, pose by pose."""
            n = 0
            for lo in range(0, POSED_B, CHUNK):
                lm = builder.rays_to_lensmap_torch(
                    g_lua, table.vx, table.vy, table.vz, table.lens_valid, S, 10, 4.0, 1.0,
                    view_basis=bases_p[lo:lo + CHUNK], plate=plates[lo:lo + CHUNK])
                for b in range(lm["flat_idx"].shape[0]):
                    n += int(torch.unique(lm["flat_idx"][b][lm["valid"][b]]).numel())
                del lm
            torch.cuda.empty_cache()
            return n

        npix_b = table.vx.numel()
        k6_bytes, k6_ops, k6_bound, k6_by = mode2_bound(npix_b, npix,
                                                        distinct_texels(table, plates_f), 1)
        k6_bytes_ms, k6_ops_ms = k6_bytes / HBM_BYTES_PER_S * 1e3, k6_ops / F32_OPS_PER_S * 1e3
        k13_ms, k13_plain = cuda_ms_pair(
            lambda: builder.rotate_rays(table.vx, table.vy, table.vz, bases_p),
            lambda: builder.rotate_normalize_torch(table.vx, table.vy, table.vz, bases_p))
        torch.cuda.empty_cache()
        k13_bytes = 12 * npix_b + 36 * POSED_B + 12 * POSED_B * npix_b
        k13_ops = bb.ROTATE_OPS * npix_b * POSED_B
        k13_bytes_ms = k13_bytes / HBM_BYTES_PER_S * 1e3
        k13_ops_ms = k13_ops / F32_OPS_PER_S * 1e3
        k13_bound = max(k13_bytes_ms, k13_ops_ms)
        k13_by = "bytes" if k13_bytes_ms >= k13_ops_ms else "operations"
        k13_launch = {}  # K13 by events around launches of its entry point
        k13_launch["B=64"] = bench_posed.rotate_rays_launch_ms(
            _build.library(), table.vx, table.vy, table.vz, bases_p, 20)[0]
        k13_launch["one pose"] = bench_posed.rotate_rays_launch_ms(
            _build.library(), table.vx, table.vy, table.vz, bases_p[:1].contiguous(), 50)[0]
        k13_1_bytes = 24 * npix_b + 36
        torch.cuda.empty_cache()

        # K14 on one piece of lfast.posed_card's call (1080p, B = SCRIPT_CELL_B):
        # as many poses as the stage's plan takes on this card now
        tape = script_tape.tape_of(g_lua, dev)
        require(tape is not None, f"lfast's resolver did not record as a tape: "
                f"{script_tape.tape_of.reason}")
        free_k = torch.cuda.mem_get_info(dev)[0]
        piece = min(static_ray.script_piece(table), SCRIPT_CELL_B)
        bases_k = torch.from_numpy(posed.bases_from_pose_track(posed_poses(piece))).float().to(dev)
        rays_k = builder.rotate_rays(table.vx, table.vy, table.vz, bases_k)
        out_k = torch.empty((piece,) + tuple(table.vx.shape), dtype=torch.int8, device=dev)
        script_tape.script_tape(tape, *rays_k, out_k)
        want_k = builder.script_plates(g_lua, *rays_k).clamp(-1, MAX_PLATES).to(torch.int8)
        k14_err = int((out_k.to(torch.int16) - want_k.to(torch.int16)).abs().max())
        require(torch.equal(out_k, want_k), f"K14 differs from the evaluator on a piece of "
                f"{piece} poses on {int((out_k != want_k).sum())} rays")
        del want_k
        rep_k = torch.empty_like(out_k)

        def replay_piece():
            """K14's plain version, the tape replayed, CHUNK poses at a time."""
            for lo in range(0, piece, CHUNK):
                rep_k[lo:lo + CHUNK] = script_tape.replay(tape, *(r[lo:lo + CHUNK]
                                                                  for r in rays_k))

        replay_piece()
        require(torch.equal(out_k, rep_k), "K14 differs from its tape's replay")
        k14_ms = cuda_ms(lambda: script_tape.script_tape(tape, *rays_k, out_k), 10)
        k14_replay = cuda_ms(replay_piece, 3)
        k14_eval = cuda_ms(lambda: builder.script_plates(g_lua, *rays_k).clamp(-1, MAX_PLATES),
                           3)
        k14_bytes = 13 * piece * npix_b  # the three float32 rays read, the int8 plate written
        k14_ops = sum(n.op not in ("input", "const") for n in tape.nodes) * piece * npix_b
        k14_bytes_ms = k14_bytes / HBM_BYTES_PER_S * 1e3
        k14_ops_ms = k14_ops / F32_OPS_PER_S * 1e3
        k14_bound = max(k14_bytes_ms, k14_ops_ms)
        k14_by = "bytes" if k14_bytes_ms >= k14_ops_ms else "operations"
        phase(10, f"K14 (script_tape) on a piece of {piece} poses of lfast.posed_card's call "
              f"(1080p, B = {SCRIPT_CELL_B}; {free_k} bytes free): the tape's "
              f"{len(tape.nodes)} nodes, library script_tape_{tape.digest}; byte-equal to the "
              f"evaluator (script_plates) and to the tape's replay; kernel {k14_ms:.4f} ms by "
              f"events, the replay {k14_replay:.4f} ms ({CHUNK} poses at a time), the "
              f"evaluator {k14_eval:.4f} ms (x{k14_eval / k14_ms:.1f}); {k14_bytes} bytes "
              f"({k14_bytes_ms:.4f} ms), {k14_ops} operations ({k14_ops_ms:.4f} ms); bound "
              f"{k14_bound:.4f} ms by {k14_by}, {100 * k14_bound / k14_ms:.1f} % of it")
        del bases_k, rays_k, out_k, rep_k
        torch.cuda.empty_cache()

        resolver_ms = cuda_ms(lambda: static_ray.script_pose_plates(table, bases_p, g_lua), 3)
        wall_f = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fast_p.render_posed(frames_dev, poses)
            torch.cuda.synchronize()
            wall_f.append((time.perf_counter() - t0) * 1e3)
        phase(10, f"lfast render_posed at 1080p B={POSED_B}: every pose bit-equal to "
              f"static_ray_posed_plain on the same plates, K13 to its plain version {CHUNK} poses "
              f"at a time; {posed_share:.6f} of the pixels differ from the built-in fast's "
              f"render_posed.  The resolver over the posed batch (K13 and K14 on "
              f"{POSED_B} x {npix_b} rays) {resolver_ms:.4f} ms, K13 alone {k13_ms:.4f} ms "
              f"(plain {k13_plain:.4f} ms; {k13_bytes} bytes, {k13_ops} f32 operations, bound "
              f"{k13_bound:.4f} ms by {k13_by}, {100 * k13_bound / k13_ms:.1f} % of it); K6 "
              f"mode 2 u8 k=1: kernel {k6_ms:.4f} ms by the events, plain {k6_plain:.4f} ms; "
              f"{k6_bytes} bytes ({k6_bytes_ms:.4f} ms), {k6_ops} f32 operations "
              f"({k6_ops_ms:.4f} ms); bound {k6_bound:.4f} ms by {k6_by}, "
              f"{100 * k6_bound / k6_ms:.1f} % of it; render_posed end to end "
              f"{', '.join(f'{w:.3f}' for w in wall_f)} ms of wall clock")

        # K6 mode 2 on the other operands: u8 at k = 2, RGBA at k = 1
        k6_more = {"u8 k=1": (k6_ms, k6_plain, k6_bytes, k6_ops, (k6_bound, k6_by))}
        lut = torch.from_numpy(rgba_lut(fast_p.palette).view(np.int32)).to(dev)
        fast_p.render_posed(frames_dev, poses, render_scale=2)
        kern2 = fast_p._posed_cache[1]
        plates_2 = static_ray.script_pose_plates(kern2.ray_table, bases_p, g_lua)
        src_rgba = posed.posed_layout(lut[frames_dev.long()], 6)
        bg_rgba = lut[kern.background.long()]
        for what, kk, tb, sk, bg, pl, el in (
                ("u8 k=2", kern2, kern2.ray_table, src_p, kern2.background, plates_2, 1),
                ("RGBA k=1", kern, table, src_rgba, bg_rgba, plates_f, 4)):
            k_ = 2 if what == "u8 k=2" else 1
            a6 = (sk, tb, bases_p, g_lua, S, kk.numcells, kk.cell_size, kk.pad_size, expanded,
                  bg, k_)
            got6 = static_ray.static_ray_posed(*a6, plates=pl)
            for lo in range(0, POSED_B, CHUNK):
                sl = slice(lo, lo + CHUNK)
                ref = static_ray.static_ray_posed_plain(
                    sk[sl], tb, bases_p[sl], g_lua, S, kk.numcells, kk.cell_size, kk.pad_size,
                    expanded, bg, k_, plates=pl[sl])
                e = int((got6[sl].long() - ref.long()).abs().max())
                require(torch.equal(got6[sl], ref), f"K6 mode 2 {what} poses {lo}.. differ "
                        f"from static_ray_posed_plain (max {e})")
                k6_err = max(k6_err, e)
            del got6, ref
            ms_, plain_ = cuda_ms_pair(lambda: static_ray.static_ray_posed(*a6, plates=pl),
                                       lambda: static_ray.static_ray_posed_plain(*a6,
                                                                                 plates=pl))
            nb_ = tb.vx.numel()
            nbytes, ops, bound, by = mode2_bound(nb_, nb_ * k_ * k_, distinct_texels(tb, pl),
                                                 el)
            k6_more[what] = (ms_, plain_, nbytes, ops, (bound, by))
            torch.cuda.empty_cache()
        del plates_2, src_rgba, kern2
        phase(10, f"before the redesign of K13 and K6's mode 2 (this phase, NVIDIA H100 80GB "
              f"HBM3, 700 W): {BEFORE_REDESIGN}")
        k13_64_bytes_ms = k13_bytes / HBM_BYTES_PER_S * 1e3
        k13_1_ms = k13_1_bytes / HBM_BYTES_PER_S * 1e3
        phase(10, f"K13 at 1080p by events around launches of its entry point: B={POSED_B} "
              f"rotated {k13_launch['B=64']:.4f} ms against its byte bound "
              f"{k13_64_bytes_ms:.4f} ms ({100 * k13_64_bytes_ms / k13_launch['B=64']:.1f} %); "
              f"one pose (the build's call) {k13_launch['one pose']:.4f} ms against "
              f"{k13_1_ms:.4f} ms ({k13_1_bytes} bytes, "
              f"{100 * k13_1_ms / k13_launch['one pose']:.1f} %)")
        for what, (ms_, plain_, nbytes, ops, (bound, by)) in k6_more.items():
            phase(10, f"K6 mode 2 (lfast) {what} B={POSED_B}: kernel {ms_:.4f} ms by the events "
                  f"(bit-equal to its plain version), plain {plain_:.4f} ms; {nbytes} bytes, "
                  f"{ops} f32 operations; bound {bound:.4f} ms by {by}, "
                  f"{100 * bound / ms_:.1f} % of it")
        del src_p, plates_f, args6, posed_f

        # ------------------------------------------------ g: lfast zoom sweep, K9 mode 2
        step_rays = builder.lens_rays_torch(lens_e, torch.tensor(scales, dtype=torch.float64),
                                            W, H, dev)
        plates_g = builder.script_plates(g_lua, *builder.rotate_rays(*step_rays[:3])).clamp(
            -1, 6).to(torch.int8)
        zero_bg = torch.zeros((H, W), dtype=torch.uint8, device=dev)
        src_g = torch.from_numpy(np.ascontiguousarray(frames[..., 0])).to(dev).reshape(-1)
        args9 = (src_g, *step_rays, g_lua, S, 10.0, 4.0, 1.0, False, zero_bg)
        got = posed.sweep_remap(*args9, plates=plates_g)
        require(torch.equal(got, sweep_g), "zoom_sweep_remap on lfast differs from sweep_remap "
                "on the same rays")
        k9_err = 0
        for n in range(LUA_SWEEP_STEPS):
            ref = posed.sweep_remap_plain(src_g, *(r[n:n + 1] for r in step_rays), g_lua, S,
                                          10.0, 4.0, 1.0, False, zero_bg,
                                          plates=plates_g[n:n + 1])
            e = int((got[n:n + 1].long() - ref.long()).abs().max())
            require(torch.equal(got[n:n + 1], ref),
                    f"sweep_remap mode 2 step {n} differs from its plain version (max {e})")
            k9_err = max(k9_err, e)
        k9_ms, k9_plain = cuda_ms_pair(lambda: posed.sweep_remap(*args9, plates=plates_g),
                                       lambda: posed.sweep_remap_plain(*args9, plates=plates_g))
        k13_steps_ms, rot_g = bench_posed.rotate_rays_launch_ms(_build.library(),
                                                                *step_rays[:3], None, 20)
        for a, b in zip(rot_g, builder.rotate_normalize_torch(*step_rays[:3])):
            require(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
                    and torch.equal(a.isnan(), b.isnan()),
                    "rotate_rays on the sweep's tables differs from its plain version")
        del rot_g
        k13_steps_bytes = 24 * npix * LUA_SWEEP_STEPS
        k13_steps_bound = k13_steps_bytes / HBM_BYTES_PER_S * 1e3
        phase(10, f"K13 on the {LUA_SWEEP_STEPS}-step sweep's tables (not rotated) at 1080p, "
              f"bit-equal to its plain version: {k13_steps_ms:.4f} ms by events around "
              f"launches of its entry point, against its byte bound {k13_steps_bound:.4f} ms "
              f"({k13_steps_bytes} bytes, {100 * k13_steps_bound / k13_steps_ms:.1f} %)")
        seen = torch.zeros(src_g.numel(), dtype=torch.bool, device=dev)
        holes = False
        for n in range(LUA_SWEEP_STEPS):
            lm = builder.rays_to_lensmap_torch(g_lua, *(r[n] for r in step_rays), S, 10.0,
                                               4.0, 1.0, plate=plates_g[n])
            seen[lm["flat_idx"][lm["valid"]].long()] = True
            holes |= not bool(lm["valid"].all())
        k9_bytes = (LUA_SWEEP_STEPS * npix * (bb.RESOLVE_BYTES_IN + 1 + 1) + int(seen.sum())
                    + (npix if holes else 0))
        k9_ops = bb.resolve_ops_per_pixel(g_lua, rotate=False) * npix * LUA_SWEEP_STEPS
        k9_bytes_ms, k9_ops_ms = k9_bytes / HBM_BYTES_PER_S * 1e3, k9_ops / F32_OPS_PER_S * 1e3
        k9_bound = max(k9_bytes_ms, k9_ops_ms)
        k9_by = "bytes" if k9_bytes_ms >= k9_ops_ms else "operations"
        phase(10, f"lfast zoom_sweep_remap, {LUA_SWEEP_STEPS} steps (f_fov {fovs[0]}.."
              f"{fovs[-1]}) at 1080p: K9 in mode 2 bit-equal to its plain version step by "
              f"step; kernel {k9_ms:.4f} ms, plain {k9_plain:.4f} ms; {k9_bytes} bytes "
              f"({k9_bytes_ms:.4f} ms), {k9_ops} f32 operations ({k9_ops_ms:.4f} ms); bound "
              f"{k9_bound:.4f} ms by {k9_by}, {100 * k9_bound / k9_ms:.1f} % of it")
        del step_rays, plates_g, got, sweep_g

        # ------------------------------------------------ h: scat, the host routes
        require(isinstance(scat_lm.flat_idx, np.ndarray), "scat did not build on the host")
        k = scat._kernel
        require(torch.equal(out_h, remap.remap_gather_plain(
            src, k.flat_idx, k.valid, k.background, fill=True).reshape(out_h.shape)),
            "scat: render differs from K1's plain version")
        for b in (0, B_MAIN - 1):
            require(np.array_equal(out_h[..., b].cpu().numpy(), scat.render_host(frames[..., b])),
                    f"scat: render frame {b} differs from host_remap")
        kern_h = scat._posed_cache[1]
        src_h, bases_h, expanded = posed.prep_posed_inputs(frames_dev[..., :CHUNK],
                                                           bases_np[:CHUNK], S,
                                                           kern_h.background, dev)
        ref = static_ray.static_ray_posed_plain(src_h, kern_h.ray_table, bases_h, kern_h.globe,
                                                S, kern_h.numcells, kern_h.cell_size,
                                                kern_h.pad_size, expanded, kern_h.background, 2)
        require(torch.equal(posed_h[:CHUNK], ref),
                "scat render_posed k=2 differs from static_ray_posed_plain")
        exact_share = float((exact_h[0] != posed_h[0]).float().mean())
        require(exact_share <= 0.02, f"scat's exact pose differs from its K6 pose on "
                f"{exact_share}")
        phase(10, f"scat (jittable False) on the exact host route: its exact host build "
              f"{t['scat exact']:.3f} s (the scalar interpreter, a pixel at a time), the render "
              f"bit-equal to K1's plain version and host_remap for frames 0 and "
              f"{B_MAIN - 1}; render_posed k=2 through the host ray table "
              f"({t['scat posed']:.3f} s, the table's build included) bit-equal to "
              f"static_ray_posed_plain for poses 0-{CHUNK - 1}; one exact pose at k=2 "
              f"({t['scat exact pose']:.3f} s) differs from its K6 pose on {exact_share:.6f} "
              f"of the pixels; phase 10 took {time.perf_counter() - phase_t0:.3f} s")
        del out_h, posed_h, exact_h, src_h
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    counted = {"lensmap_resolve_given": launches["lensmap_resolve_given"],
               "static_ray_posed_given": launches["static_ray_posed_given"],
               "sweep_remap_given": launches["sweep_remap_given"],
               "rotate_rays": launches["rotate_rays"],
               "script_tape": launches["script_tape"]}
    rows = [
        ("lensmap_resolve_given", "lensmap.cu", "blinky_tpu/lensmap/builder.py:228", k8_err,
         k8_dev, k8_plain, k8_bound, k8_by, None, None),
        ("static_ray_posed_given", "posed.cu", "blinky_tpu/kernels/static_ray.py:235", k6_err,
         k6_ms, k6_plain, k6_bound, k6_by, None, None),
        ("sweep_remap_given", "posed.cu", "blinky_tpu/kernels/posed.py:294", k9_err, k9_ms,
         k9_plain, k9_bound, k9_by, None, None),
        ("rotate_rays", "lensmap.cu", "blinky_tpu/lensmap/builder.py:185", 0, k13_ms,
         k13_plain, k13_bound, k13_by, None, None),
        ("script_tape", f"../build/script_tape_{tape.digest}.cu",
         "blinky_tpu/lensmap/builder.py:228", k14_err, k14_ms, k14_replay, k14_bound, k14_by,
         k14_eval, "script_plates (the evaluator's tensor mode)"),
    ]
    return counted, rows


# phase 11: the rest of the Session surface.  The cold lens of the partial
# preview is one no earlier phase built on the float32 builder in a Session
# of this size; its exact 1080p host build takes about a second
SLICE_BUDGET_S = 1 / 60
COLD_LENS = "hammer"


def surface_phase(dev, frames, frames_dev, kernels):
    """Phase 11: the fisheye-0 plain view, time-sliced builds with the float32
    preview, f_saveglobe and the console commands.  Its launch counts are
    printed here; the kernels line keeps each kernel's launches in its own
    path's phase."""
    import os
    import shutil
    import tempfile

    from blinky_tpu_torch import lenses
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.bench.throughput import device_pano
    from blinky_tpu_torch.camera import view_basis_from_angles
    from blinky_tpu_torch.io.cubemap import save_globe_pcx
    from blinky_tpu_torch.kernels import ingest, remap
    from blinky_tpu_torch.lensmap import builder

    S, H, W = 1080, 1080, 1920
    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    panos = device_pano(PANO_H, PANO_W, PANO_B, device=dev)  # phase 8's panos
    torch.cuda.synchronize()
    src = frames_dev.reshape(-1, B_MAIN)

    # ------------------------------------------------ the path, counted
    path_kernels = {"remap_gather": remap.remap_gather, "remap_lut": remap.remap_lut,
                    "lensmap_resolve": builder.lensmap_resolve,
                    "equirect_gather": ingest.equirect_gather,
                    "downsample_rgba": remap.downsample_rgba}
    for fn in list(kernels.values()) + list(path_kernels.values()):
        fn.launches = 0
    plain = Session(W, H, device=dev)                         # a: the plain view
    views, plain_s = {}, {}
    for fov in (90, 110):
        t0 = time.perf_counter()
        plain.cmd(f"fisheye 0; fov {fov}")
        out = plain.render(frames_dev)
        torch.cuda.synchronize()
        plain_s[fov] = time.perf_counter() - t0  # the exact host build, then K1
        views[fov] = (out, plain.render(frames_dev, decode_rgb=True), plain._plain_cache[1],
                      plain._plain_lm_cache[1])
    plain.cmd("setviewangles 10 30 0")                        # b: rotated, on K8
    out_rot = plain.render(frames_dev)
    k_rot, lm_rot = plain._plain_cache[1], plain._plain_lm_cache[1]
    eq = Session(EQ_W, EQ_H, platesize=EQ_S, device=dev)      # c: render_equirect
    eq.cmd("fisheye 0")
    eq_out = eq.render_equirect(panos, mode="compact")
    aa = Session(W, H, device=dev)                            # d: render_aa
    aa.cmd("fisheye 0; fov 100")
    aa_out = aa.render_aa(frames_dev, factor=AA_FACTOR)
    sl = Session(W, H, device=dev, build_budget_s=SLICE_BUDGET_S)  # e: the float32 preview
    sl.cmd("f_lens stereographic")
    require(sl.warm_device_builder(), "stereographic has no device builder")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sl.cmd("f_lens stereographic")
    first = sl.render(frames_dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    require(sl.build_progress is not None and not sl._preview_is_partial
            and isinstance(sl._lensmap.flat_idx, torch.Tensor),
            "the time-sliced stereographic build did not preview through the float32 builder")
    preview_lm, preview_k, progress0 = sl._lensmap, sl._kernel, sl.build_progress
    slice_walls, final = [first_s], first
    while sl.build_progress is not None:
        t1 = time.perf_counter()
        final = sl.render(frames_dev)
        torch.cuda.synchronize()
        slice_walls.append(time.perf_counter() - t1)
    sliced_s = time.perf_counter() - t0
    bg = np.full((H, W), 251, np.uint8)                       # f: the partial preview
    cold = Session(W, H, device=dev, build_budget_s=SLICE_BUDGET_S)
    cold.set_background(bg)
    cold.cmd(f"f_lens {COLD_LENS}")
    partials = []
    while True:
        t1 = time.perf_counter()
        out = cold.render(frames_dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        pb = cold._pending_build
        # (the render, its wall time, the table it showed, the rows built)
        partials.append((out[..., 0].cpu().numpy(), out[..., B_MAIN - 1].cpu().numpy(),
                         (out[pb._row:] == 251).all().item() if pb is not None else True,
                         wall, cold._lensmap, pb._row if pb is not None else H,
                         cold._preview_is_partial))
        if pb is None:
            break
    del out
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_saveglobe_"))
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        sv = Session(W, H, device=dev)                        # g: f_saveglobe
        sv.cmd("f_saveglobe shot")
        sv.render(frames_dev)
        shot = {i: (tmp / f"shot{i}.pcx").read_bytes() for i in range(6)}
        eqs = Session(EQ_W, EQ_H, platesize=EQ_S, device=dev)
        eqs.cmd("f_saveglobe eq 1")
        eqs_out = eqs.render_equirect(panos, mode="compact")
        eq_files = {i: (tmp / f"eq{i}.pcx").read_bytes() for i in range(6)}
        con = Session(W, H, device=dev,                       # h: the console
                      cmdline_cmds=["f_fov 150", 'bind 8 "f_lens cube"'])
        con.cmd("f_shortcutkeys")
        con.press_key("4")
        con.cmd('bind 3 "f_globe tetra"; unbind 5; bind 3; bind 5; stuffcmds; stuffcmds x')
        con_out = con.render(frames_dev)
        cfg = tmp / "config.cfg"
        con.write_config(cfg)
        fresh = Session(W, H, device=dev, defaults=False)
        fresh.cmd(f"exec {cfg}")
        fresh_out = fresh.render(frames_dev)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in path_kernels.items()}
        run_s = time.perf_counter() - phase_t0
        phase(11, f"launches in the Session surface's run (a: fisheye 0 at fov 90 and 110, "
              f"plain and decode_rgb, b: after setviewangles 10 30 0, c: render_equirect "
              f"compact under fisheye 0, d: render_aa factor {AA_FACTOR} under fisheye 0, e: "
              f"the time-sliced stereographic build previewed by the float32 builder, f: the "
              f"{COLD_LENS} build previewed by its partial table, g: f_saveglobe through render "
              f"and render_equirect, h: the console session and its config's replay): "
              f"{launches}; {run_s:.3f} s")
        for name, n in launches.items():
            require(n >= 1, f"{name} was not launched by the Session surface's path")

        # ------------------------------------------------ g and h: files and console
        for i in range(6):
            (tmp / f"shot{i}.pcx").unlink()
            (tmp / f"eq{i}.pcx").unlink()
        save_globe_pcx("shot", frames[..., 0], sv.globe, sv.palette)
        require(all(shot[i] == (tmp / f"shot{i}.pcx").read_bytes() for i in range(6)),
                "f_saveglobe from the batch on the card differs from save_globe_pcx of frame 0")
        require(sv.console[-6:] == [f"Wrote shot{i}.pcx" for i in range(6)],
                f"f_saveglobe's console: {sv.console[-6:]}")
        require(not eqs._equirect_fused, "render_equirect composed a chain with a save pending")
        faces = eqs._equirect_cache[1](panos)
        lane0 = faces.view(torch.int32)[..., 0].cpu().numpy().view(np.uint32)
        save_globe_pcx("eq", lane0, eqs.globe, eqs.palette, True)
        require(all(eq_files[i] == (tmp / f"eq{i}.pcx").read_bytes() for i in range(6)),
                "f_saveglobe through render_equirect differs from the faces' lane 0")
        require(torch.equal(eqs_out.view(torch.int32), eqs.render(faces).view(torch.int32)),
                "render_equirect with a save pending differs from the faces' render")
        require(torch.equal(eqs.render_equirect(panos, mode="compact").view(torch.int32),
                            eqs_out.view(torch.int32)),
                "render_equirect compact after the save differs from the faces route")
        phase(11, f"f_saveglobe shot, then a render of the B={B_MAIN} batch on the card: its 6 "
              "PCX files equal save_globe_pcx of frame 0 from the host, byte for byte; "
              "f_saveglobe eq 1, then render_equirect compact: the faces route (no composed "
              "chain), its 6 files equal those of the ingested faces' lane 0 (low byte), and "
              "its screens equal the faces' render and the next compact call's")
        del faces
        require(con.lens_name == "winkeltripel" and con.zoom.command() == "f_fov 150"
                and con.bindings["3"] == "f_globe tetra" and "5" not in con.bindings
                and con.bindings["8"] == "f_lens cube",
                f"the console session's state: {con.lens_name} {con.zoom.command()} "
                f"{con.bindings}")
        require(con.console[-3:] == ['"3" = "f_globe tetra"', '"5" is not bound',
                                     "stuffcmds : execute command line parameters"],
                f"the console session's last lines: {con.console[-3:]}")
        require(fresh.config_str() == con.config_str(),
                "the config's replay gives another config")
        require(torch.equal(fresh_out, con_out), "the config's replay renders other screens")
        require(torch.equal(fresh_out, remap.remap_gather_plain(
            src, fresh._kernel.flat_idx, fresh._kernel.valid, fresh._kernel.background,
            fill=True).reshape(fresh_out.shape)), "the replayed render differs from K1's plain "
            "version")
        phase(11, "console: f_shortcutkeys, press_key('4') (winkeltripel), bind / unbind, "
              "stuffcmds of the command line (f_fov 150, bind 8) and its usage line; "
              f"config_str ({len(con.config_str().splitlines())} lines) written and exec'd "
              f"into a fresh Session: the same config and bit-equal {W}x{H} screens at "
              f"B={B_MAIN}")
        del con_out, fresh_out
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------ a and b: the plain view
    rect = lenses.get("rectilinear", plain.globe)
    for fov, (out, rgb, k, lm) in views.items():
        require(isinstance(lm.flat_idx, np.ndarray), f"fov {fov}: the plain table is not exact")
        e = int((out.int() - remap.remap_gather_plain(
            src, k.flat_idx, k.valid, k.background, fill=True).reshape(out.shape).int())
            .abs().max())
        require(e == 0, f"fisheye 0 fov {fov}: K1 differs from its plain version ({e})")
        require(torch.equal(rgb, remap.remap_lut_plain(
            src, k.flat_idx, k.valid, k.tint, k.background, None, k.rgb_lut).reshape(rgb.shape)),
            f"fisheye 0 fov {fov}: decode_rgb (K2) differs from its plain version")
        for b in (0, B_MAIN - 1):
            require(np.array_equal(out[..., b].cpu().numpy(),
                                   remap.host_remap(lm, frames[..., b], plain.palette)),
                    f"fisheye 0 fov {fov}: frame {b} differs from host_remap")
            require(np.array_equal(rgb[..., b, :].cpu().numpy(), remap.host_remap(
                lm, frames[..., b], plain.palette, decode_rgb=True)),
                f"fisheye 0 fov {fov}: decode_rgb frame {b} differs from host_remap")
        n = k.flat_idx.numel()
        rows = source_rows(k.flat_idx, k.valid, src.shape[0], True)
        nbytes = n * 6 + (rows + n) * B_MAIN
        k1_ms, k1_plain = cuda_ms_pair(
            lambda: remap.remap_gather(src, k.flat_idx, k.valid, k.background, fill=True),
            lambda: remap.remap_gather_plain(src, k.flat_idx, k.valid, k.background, fill=True))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        phase(11, f"fisheye 0, fov {fov}: the plain table (rectilinear, scale {lm.scale:.6f}) "
              f"built on the host and the first render in {plain_s[fov]:.3f} s; "
              f"{float(lm.valid.mean()):.6f} of the pixels valid; K1 and K2 (decode_rgb) "
              f"bit-equal to their plain versions and to host_remap for frames 0 and "
              f"{B_MAIN - 1}; K1 {k1_ms:.4f} ms, plain {k1_plain:.4f} ms; {rows} distinct "
              f"source rows, {nbytes} bytes, bound {bound_ms:.4f} ms, "
              f"{100 * bound_ms / k1_ms:.1f} % of it")
    del views
    require(isinstance(lm_rot.flat_idx, torch.Tensor) and lm_rot.flat_idx.is_cuda,
            "the rotated plain view did not build on the card")
    vb = torch.from_numpy(builder.basis_f32(view_basis_from_angles(10.0, 30.0, 0.0))).to(dev)
    rays = builder.lens_rays_torch(rect, lm_rot.scale, W, H, dev)
    want = builder.rays_to_lensmap_torch(plain.globe, *rays, S, 10, 4.0, 1.0, view_basis=vb)
    for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
        require(torch.equal(getattr(lm_rot, f), want[f]),
                f"the rotated plain view's {f} differs from rays_to_lensmap_torch")
    del rays, want
    require(torch.equal(out_rot, remap.remap_gather_plain(
        src, k_rot.flat_idx, k_rot.valid, k_rot.background, fill=True).reshape(out_rot.shape)),
        "the rotated plain view's render differs from K1's plain version")
    lm_rot_np = lm_rot.to_numpy()
    for b in (0, B_MAIN - 1):
        require(np.array_equal(out_rot[..., b].cpu().numpy(),
                               remap.host_remap(lm_rot_np, frames[..., b], plain.palette)),
                f"the rotated plain view's frame {b} differs from host_remap of its table")
    exact_rot = plain.render_host(frames[..., 0])  # the same view on the exact host builder
    share = float((out_rot[..., 0].cpu().numpy() != exact_rot).mean())
    require(share <= 0.02, f"the rotated plain view differs from the exact one on {share}")
    phase(11, "fisheye 0 after setviewangles 10 30 0 under 'auto': the plain table built on the "
          "card (the lens stage, then K8, bit-equal to rays_to_lensmap_torch on the same rays), "
          f"then K1, bit-equal to its plain version and host_remap for frames 0 and "
          f"{B_MAIN - 1}; frame 0 differs from the exact host build's view on {share:.6f} of "
          "the pixels")
    del out_rot

    # ------------------------------------------------ c and d: equirect and AA
    require(eq_out.dtype == torch.uint32 and tuple(eq_out.shape) == (EQ_H, EQ_W, PANO_B),
            f"render_equirect under fisheye 0 gave {eq_out.dtype} {tuple(eq_out.shape)}")
    require(not eq._equirect_fused, "render_equirect composed a chain under fisheye 0")
    eq_lm = eq._plain_lm_cache[1]
    bits = panos.view(torch.int32).reshape(-1, PANO_B)
    ing = ingest.EquirectIngest(PANO_H, PANO_W, EQ_S, globe=eq.globe, bilinear=True, device=dev)
    for b in (0, PANO_B - 1):
        pano = bits[:, b].cpu().numpy().view(np.uint32).reshape(PANO_H, PANO_W)
        host = remap.host_remap(eq_lm, ing.host(pano), eq.palette)
        require(np.array_equal(eq_out.view(torch.int32)[..., b].cpu().numpy().view(np.uint32),
                               host),
                f"render_equirect under fisheye 0: lane {b} differs from the all-host path")
    del bits
    hi_sess = next(iter(aa._aa_cache.values()))
    require(not hi_sess.fisheye_enabled and hi_sess.fov == 100.0,
            "render_aa's hi-res session did not replay fisheye 0 and fov")
    hi = hi_sess.render(aa._rgba_screen(frames_dev))
    require(torch.equal(aa_out.view(torch.int32),
                        remap.downsample_rgba_plain(hi.view(torch.int32), AA_FACTOR)),
            "render_aa under fisheye 0 differs from downsample_rgba_plain of its hi-res render")
    hk = hi_sess._plain_cache[1]
    rgba_src = aa._rgba_screen(frames_dev).view(torch.int32).reshape(-1, B_MAIN)
    require(torch.equal(hi.view(torch.int32), remap.remap_gather_plain(
        rgba_src, hk.flat_idx, hk.valid, hk.background_rgba).reshape(hi.shape)),
        "render_aa's hi-res plain view differs from K1's plain version")
    del hi, rgba_src
    phase(11, f"render_equirect compact under fisheye 0 ({PANO_W}x{PANO_H} -> {EQ_W}x{EQ_H} "
          f"B={PANO_B}): the faces (K10) through the plain view (K1), u32, lanes 0 and "
          f"{PANO_B - 1} equal EquirectIngest.host + host_remap; render_aa factor "
          f"{AA_FACTOR} under fisheye 0 (the hi-res session replays fisheye 0 and fov 100: K1 "
          "at 3840x2160, then K11) bit-equal to the plain versions")
    del eq_out, aa_out, panos

    # ------------------------------------------------ e and f: time-sliced builds
    blk = Session(W, H, device=dev)
    blk.cmd("f_lens stereographic")
    t1 = time.perf_counter()
    blk.lensmap
    blocking_s = time.perf_counter() - t1
    want = blk.render(frames_dev)
    require(torch.equal(final, want),
            "the time-sliced stereographic build's final screens differ from a blocking build's")
    require(np.array_equal(sl.lensmap.flat_idx, blk.lensmap.flat_idx),
            "the time-sliced build's table differs from the blocking build's")
    require(torch.equal(first, remap.remap_gather_plain(
        src, preview_k.flat_idx, preview_k.valid, preview_k.background,
        fill=True).reshape(first.shape)), "the float32 preview's render differs from K1's "
        "plain version")
    rays = builder.lens_rays_torch(sl.lens, preview_lm.scale, W, H, dev)
    want_t = builder.rays_to_lensmap_torch(
        sl.globe, *rays, S, 10, 4.0, 1.0,
        view_basis=torch.from_numpy(builder.basis_f32(builder.IDENTITY_BASIS)).to(dev))
    require(torch.equal(preview_lm.flat_idx, want_t["flat_idx"])
            and torch.equal(preview_lm.valid, want_t["valid"]),
            "the float32 preview's table differs from rays_to_lensmap_torch")
    prev_share = float((preview_lm.flat_idx.cpu().numpy() != blk.lensmap.flat_idx).mean())
    del rays, want_t
    # the first frame's parts, on a second switch: the command, the preview
    # (the float32 build and the exact build's empty tables), the first slice,
    # then the remap kernel on the preview's tables and K1
    parts = []
    for step in (lambda: sl.cmd("f_lens stereographic"), sl._rebuild,
                 lambda: sl._advance_build(SLICE_BUDGET_S),
                 lambda: remap.RemapKernel(sl._lensmap, sl.palette, None,
                                           device=dev)(frames_dev)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        parts.append(1e3 * (time.perf_counter() - t1))
    sl.lensmap  # finishes the build
    phase(11, f"Session({W}, {H}, build_budget_s=1/60), the float32 builder warm, then f_lens "
          f"stereographic: the first frame (the float32 preview: the lens stage, K8, K1; "
          f"bit-equal to the plain versions; {prev_share:.6f} of its pixels off the exact "
          f"table) {1e3 * first_s:.3f} ms after the command, against the blocking exact build's "
          f"{blocking_s:.3f} s; progress after it {progress0:.4f}; {len(slice_walls)} renders "
          f"until build_progress is None, the largest render call "
          f"{1e3 * max(slice_walls):.3f} ms, the median "
          f"{1e3 * float(np.median(slice_walls)):.3f} ms, {sliced_s:.3f} s in all; the final "
          f"screens bit-equal to the blocking Session's.  A second switch, by parts: the "
          f"command {parts[0]:.3f} ms, the preview's build {parts[1]:.3f} ms, the first slice "
          f"{parts[2]:.3f} ms, the remap kernel and K1 {parts[3]:.3f} ms")
    del final, want, first
    upload = []
    for b_idx, (o0, o63, bg_ok, wall, lm, built, partial) in enumerate(partials):
        require(bg_ok, f"{COLD_LENS} render {b_idx}: an unbuilt row differs from the background")
        lm_np = lm if isinstance(lm.flat_idx, np.ndarray) else lm.to_numpy()
        for b, o in ((0, o0), (B_MAIN - 1, o63)):
            require(np.array_equal(o, remap.host_remap(lm_np, frames[..., b], cold.palette, bg)),
                    f"{COLD_LENS} render {b_idx}: frame {b} differs from host_remap of the "
                    "table it showed")
        require(partial or built == H, f"{COLD_LENS} render {b_idx}: not the partial preview")
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        remap.RemapKernel(partials[0][4], cold.palette, bg, device=dev)
        torch.cuda.synchronize()
        upload.append(time.perf_counter() - t1)
    walls = [p[3] for p in partials]
    # a partial render's parts, on a second switch: the slice, the partial
    # table's copy, the remap kernel (its tables uploaded) and K1
    cold.cmd(f"f_lens {COLD_LENS}")
    cold._rebuild()
    pb, cparts = cold._pending_build, []
    for step in (lambda: pb.step(SLICE_BUDGET_S), pb.partial,
                 lambda: remap.RemapKernel(pb.partial(), cold.palette, bg,
                                           device=dev)(frames_dev)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        cparts.append(1e3 * (time.perf_counter() - t1))
    cold_lm = cold.lensmap
    require(np.array_equal(cold_lm.flat_idx, partials[-1][4].flat_idx),
            f"{COLD_LENS}: the last table differs from the exact one")
    phase(11, f"{COLD_LENS} with a cold float32 builder, build_budget_s=1/60: {len(partials)} "
          f"renders through the partial preview, each a new RemapKernel (its tables uploaded) "
          f"and K1; every render's unbuilt rows are the background and frames 0 and "
          f"{B_MAIN - 1} equal host_remap of the table it showed; render wall clock with its "
          f"upload: largest {1e3 * max(walls):.3f} ms, median "
          f"{1e3 * float(np.median(walls)):.3f} ms; a {W}x{H} table's upload alone "
          + ", ".join(f"{1e3 * u:.3f}" for u in upload) + f" ms; a second switch's render "
          f"by parts: the slice {cparts[0]:.3f} ms, the partial table's copy {cparts[1]:.3f} "
          f"ms, its copy, remap kernel (the upload) and K1 {cparts[2]:.3f} ms; phase 11 took "
          f"{time.perf_counter() - phase_t0:.3f} s")
    del partials
    torch.cuda.empty_cache()


REPLAY_N = 96          # recorded frames: one full batch of B_MAIN, then 32 padded
DEM_MESSAGES = 24      # the .dem track's messages, resampled to REPLAY_N poses
PNG_SCREENS = 8        # decode_rgb screens through the PNG codec
FACE_FRAMES = 8        # true-colour PNG face sets
IMPORT_PANOS = 4       # equirect panoramas through import_equirect_dir
IMPORT_PANO_H, IMPORT_PANO_W, IMPORT_S = 2048, 4096, 720
PROFILE_ITERS = 5


def recorded_phase(dev, kernels):
    """Phase 12: recorded inputs and outputs, in a temporary directory that
    it removes.  Returns the launches of K1, K2, K6 and K7 in the path's
    run, which the kernels line adds to each kernel's own path's."""
    import shutil
    import tempfile

    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.bench.throughput import device_pano
    from blinky_tpu_torch.io import dataset, demfile, gif, pak, png
    from blinky_tpu_torch.io.cubemap import save_globe_pcx, synthetic_cubemap, to_batch_layout
    from blinky_tpu_torch.kernels import ingest, posed, remap, static_ray
    from blinky_tpu_torch.palette import default_palette

    S, H, W, B = 1080, 1080, 1920, B_MAIN
    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="blinky_recorded_"))
    try:
        # ------------------------------------------------ the recordings, written
        sess = Session(W, H, device=dev)
        pal = sess.palette
        base = synthetic_cubemap(S)
        seq = np.stack([np.roll(base, i, axis=2) for i in range(REPLAY_N)])
        (tmp / "saveglobe").mkdir()
        t0 = time.perf_counter()
        for i in range(REPLAY_N):
            save_globe_pcx(tmp / "saveglobe" / f"frame{i:04d}_", seq[i], sess.globe, pal,
                           with_margins=True)
        pcx_enc_s = (time.perf_counter() - t0) / REPLAY_N
        track = np.stack([np.linspace(-30, 30, DEM_MESSAGES),
                          np.linspace(0, 690, DEM_MESSAGES) % 360,
                          10 * np.sin(np.linspace(0, 6, DEM_MESSAGES))], 1).astype(np.float32)
        demfile.write_dem(tmp / "track.dem", track)
        (tmp / "faces").mkdir()
        face_rgb = remap.unpack_rgb(remap.frames_to_rgba(seq[:FACE_FRAMES], pal))
        t0 = time.perf_counter()
        for n in range(FACE_FRAMES):
            for i in range(6):
                (tmp / "faces" / f"face{n:02d}_{i}.png").write_bytes(
                    png.encode_png(face_rgb[n, i]))
        face_enc_s = (time.perf_counter() - t0) / FACE_FRAMES
        (tmp / "panos").mkdir()
        panos_u32 = device_pano(IMPORT_PANO_H, IMPORT_PANO_W, IMPORT_PANOS, device=dev)
        pano_rgb = remap.unpack_rgb(panos_u32.view(torch.int32).cpu().numpy().view(np.uint32))
        del panos_u32
        t0 = time.perf_counter()
        for n in range(IMPORT_PANOS):
            (tmp / "panos" / f"pano{n:02d}.png").write_bytes(png.encode_png(pano_rgb[:, :, n]))
        pano_enc_s = (time.perf_counter() - t0) / IMPORT_PANOS
        pak_pal = np.ascontiguousarray(np.roll(default_palette(), 1, axis=1))
        pak.write_pak(tmp / "pak0.pak", {"maps/start.bsp": b"\x1d" * 1000,
                                         "gfx/palette.lmp": pak_pal.tobytes()})
        require(sess.lensmap is not None, "the 1080p lensmap did not build")
        sess.render(seq[0][..., None])  # the remap kernel's operands, uploaded once
        torch.cuda.synchronize()
        phase(12, f"written in {tmp}: {REPLAY_N * 6} f_saveglobe PCX plates "
              f"({pcx_enc_s:.4f} s a frame of six {S}x{S} plates), a .dem of "
              f"{DEM_MESSAGES} messages, {FACE_FRAMES * 6} PNG faces at S = {S} "
              f"({face_enc_s:.4f} s a frame of six), {IMPORT_PANOS} {IMPORT_PANO_W}x"
              f"{IMPORT_PANO_H} PNG panos ({pano_enc_s:.4f} s a pano), a PAK with "
              "gfx/palette.lmp")

        # ------------------------------------------------ the path, counted
        path_kernels = {"remap_gather": remap.remap_gather, "remap_lut": remap.remap_lut,
                        "static_ray_posed": static_ray.static_ray_posed,
                        "posed_layout": posed.posed_layout}
        for fn in list(kernels.values()) + list(path_kernels.values()):
            fn.launches = 0
        t0 = time.perf_counter()
        frames, sg_pal, stems = dataset.import_saveglobe_dir(tmp / "saveglobe")
        pcx_dec_s = (time.perf_counter() - t0) / REPLAY_N
        dem = demfile.read_dem(tmp / "track.dem")
        poses = demfile.lerp_pose_track(dem.poses, REPLAY_N)
        t0 = time.perf_counter()
        dataset.write_demo(tmp / "demo.npz", frames, sg_pal, poses)
        demo_w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        demo = dataset.read_demo(tmp / "demo.npz")
        demo_r_s = time.perf_counter() - t0
        frames = demo["frames"]
        clocks, lasts = {}, {}
        for name, kw in (("plain", {}), ("f_rubix", dict(rubix=True)),
                         ("decode_rgb", dict(decode_rgb=True))):
            lasts[name], clock = dataset.timedemo(sess, frames, batch=B, **kw)
            # a FrameClock runs on: read it as timedemo returns, as its line was
            clocks[name] = (clock.frames, clock.seconds, sess.console[-1])
        screens, first = [], None
        for batch_np, n_valid in dataset.FrameBatchIterator(frames, B):
            if first is None:
                first = torch.from_numpy(batch_np).to(dev)
            screens.append(sess.render(batch_np)[..., :n_valid].cpu().numpy())
        screens = np.concatenate(screens, axis=-1)
        posed_out = sess.render_posed(first, demo["poses"][:B])
        t0 = time.perf_counter()
        faces, face_stems = dataset.import_rgb_faces_dir(tmp / "faces")
        face_dec_s = (time.perf_counter() - t0) / FACE_FRAMES
        faces_out = sess.render(to_batch_layout(faces))
        t0 = time.perf_counter()
        eq_frames, eq_stems = dataset.import_equirect_dir(tmp / "panos", platesize=IMPORT_S)
        eq_s = (time.perf_counter() - t0) / IMPORT_PANOS
        pak_sess = Session(W, H, palette=pak.load_palette_from_pak(tmp / "pak0.pak"),
                           device=dev)
        pak_out = pak_sess.render(first, decode_rgb=True)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in path_kernels.items()}
        phase(12, f"launches in the recorded path's run (import_saveglobe_dir, the demo "
              f"container, timedemo plain, f_rubix and decode_rgb over {REPLAY_N} frames, the "
              f"{REPLAY_N} screens, render_posed of the first batch on the .dem poses, the "
              f"true-colour faces, the PAK palette's decode_rgb render): {launches}")
        for name, n in launches.items():
            require(n >= 1, f"{name} was not launched by the recorded path")

        # ------------------------------------------------ codecs out, timed
        rgb8 = [lasts["decode_rgb"][..., j, :].cpu().numpy() for j in range(PNG_SCREENS)]
        t0 = time.perf_counter()
        pngs = [png.encode_png(x) for x in rgb8]
        png_enc_s = (time.perf_counter() - t0) / PNG_SCREENS
        t0 = time.perf_counter()
        back = [png.decode_png(d) for d in pngs]
        png_dec_s = (time.perf_counter() - t0) / PNG_SCREENS
        for j in range(PNG_SCREENS):
            require(np.array_equal(back[j], rgb8[j]), f"PNG round trip of screen {j} differs")
        t0 = time.perf_counter()
        gif_data = gif.encode_gif(screens, pal, delay_cs=4)
        gif_enc_s = (time.perf_counter() - t0) / REPLAY_N
        t0 = time.perf_counter()
        gif_frames, gif_pal, delays = gif.decode_gif(gif_data)
        gif_dec_s = (time.perf_counter() - t0) / REPLAY_N
        require(np.array_equal(gif_frames, screens) and np.array_equal(gif_pal, pal)
                and delays == [4] * REPLAY_N, "GIF round trip of the u8 screens differs")
        u32 = faces_out.view(torch.int32).cpu().numpy().view(np.uint32)
        t0 = time.perf_counter()
        gif32 = gif.encode_gif_u32(np.moveaxis(u32, -1, 0), delay_cs=4)
        gif32_s = time.perf_counter() - t0
        q_frames, q_pal, _ = gif.decode_gif(gif32)
        colours = len(np.unique(u32))
        exact32 = np.array_equal(q_pal[q_frames], remap.unpack_rgb(u32))
        require(colours > 256 or exact32, "encode_gif_u32 of at most 256 colours is not exact")
        phase(12, f"codecs at S = {S}, {W}x{H}: PCX {pcx_enc_s:.4f} s to encode and {pcx_dec_s:.4f} s to "
              f"decode a frame of six plates; PNG {W}x{H} RGB {png_enc_s:.4f} s to encode, "
              f"{png_dec_s:.4f} s to decode a screen ({sum(map(len, pngs)) // PNG_SCREENS} "
              f"bytes); PNG faces {face_enc_s:.4f} s to encode, {face_dec_s:.4f} s to import "
              f"a frame of six; GIF of the {REPLAY_N} u8 screens {gif_enc_s:.4f} s to encode, "
              f"{gif_dec_s:.4f} s to decode a screen ({len(gif_data)} bytes), round trip "
              f"exact; encode_gif_u32 of {FACE_FRAMES} u32 screens {gif32_s:.4f} s "
              f"({colours} colours, {'exact' if exact32 else 'quantized'}); the demo "
              f"container {demo_w_s:.3f} s to write and {demo_r_s:.3f} s to read "
              f"({frames.nbytes} bytes of frames)")

        # ------------------------------------------------ checks
        require(np.array_equal(frames, seq) and np.array_equal(sg_pal, pal)
                and stems == [f"frame{i:04d}_" for i in range(REPLAY_N)],
                "import_saveglobe_dir differs from the frames written")
        require(np.array_equal(dem.poses, track), "read_dem differs from the track written")
        require(np.array_equal(demo["poses"], poses) and demo["poses"].shape == (REPLAY_N, 3),
                "the demo container's poses differ from lerp_pose_track's")
        zero = np.zeros_like(frames[0])
        n_last = REPLAY_N - B
        for name, kw in (("plain", {}), ("f_rubix", dict(rubix=True)),
                         ("decode_rgb", dict(decode_rgb=True))):
            out, counted = lasts[name], clocks[name][0]
            require(counted == REPLAY_N, f"timedemo {name} counted {counted} frames")
            got = out.cpu().numpy()
            lane = (lambda j: got[..., j, :]) if kw.get("decode_rgb") else (lambda j: got[..., j])
            for j in range(n_last):
                require(np.array_equal(lane(j), sess.render_host(frames[B + j], **kw)),
                        f"timedemo {name}: frame {B + j} differs from host_remap")
            pad = sess.render_host(zero, **kw)
            for j in range(n_last, B):
                require(np.array_equal(lane(j), pad), f"timedemo {name}: padded lane {j} "
                        "differs from host_remap of a zero frame")
        for b in (0, B - 1, B, REPLAY_N - 1):
            require(np.array_equal(screens[..., b], sess.render_host(frames[b])),
                    f"screen {b} differs from host_remap")
        phase(12, f"timedemo plain, f_rubix and decode_rgb: the last batch's {n_last} frames "
              f"bit-equal host_remap and its {B - n_last} padded lanes host_remap of a zero "
              f"frame; the {REPLAY_N} screens' frames 0, {B - 1}, {B}, {REPLAY_N - 1} "
              "equal host_remap")
        kern = sess._posed_cache[1]
        bases = posed.bases_from_pose_track(demo["poses"][:B])
        for lo in range(0, B, CHUNK):
            src, bb, expanded = posed.prep_posed_inputs(first[..., lo:lo + CHUNK],
                                                        bases[lo:lo + CHUNK], S,
                                                        kern.background, dev)
            ref = static_ray.static_ray_posed_plain(
                src, kern.ray_table, bb, kern.globe, S, kern.numcells, kern.cell_size,
                kern.pad_size, expanded, kern.background, 1)
            e = int((posed_out[lo:lo + CHUNK].long() - ref.long()).abs().max())
            require(e == 0, f"render_posed on the .dem poses {lo}.. differs from "
                    f"static_ray_posed_plain (max {e})")
        phase(12, f"render_posed of the first batch on its {B} .dem poses (K7, K6) bit-equal "
              "static_ray_posed_plain on the card")
        want_faces = remap.frames_to_rgba(seq[:FACE_FRAMES], pal)
        require(np.array_equal(faces, want_faces) and len(face_stems) == FACE_FRAMES,
                "import_rgb_faces_dir differs from the faces written")
        for n in range(FACE_FRAMES):
            require(np.array_equal(u32[..., n], sess.render_host(faces[n])),
                    f"true-colour face frame {n} differs from host_remap")
        phase(12, f"import_rgb_faces_dir of {FACE_FRAMES} PNG face sets equals the frames "
              "written; their u32 render (K1) bit-equals host_remap")
        ing = ingest.EquirectIngest(IMPORT_PANO_H, IMPORT_PANO_W, IMPORT_S, device=dev)
        panos = remap.pack_rgba(pano_rgb)
        panos_dev = torch.from_numpy(panos.view(np.int32)).to(dev).view(torch.uint32)
        k10 = ing(panos_dev).view(torch.int32).cpu().numpy().view(np.uint32)
        require(np.array_equal(np.moveaxis(k10, -1, 0), eq_frames) and len(eq_stems) == IMPORT_PANOS,
                "import_equirect_dir differs from EquirectIngest (K10) on the card")
        one = panos_dev[..., :1].contiguous()
        k10_ms = cuda_ms(lambda: ing(one), ITERS)
        _, k10_rec, _ = profiled(lambda: ing(one), ITERS)
        k10_dev = sum(t for n_, t in k10_rec.items() if "equirect" in n_)
        phase(12, f"import_equirect_dir of {IMPORT_PANOS} {IMPORT_PANO_W}x{IMPORT_PANO_H} PNG "
              f"panos at S = {IMPORT_S} equals EquirectIngest (K10) on the card; the host "
              f"import {eq_s:.4f} s a pano (PNG decode and EquirectIngest.host) against K10's "
              f"{k10_ms:.4f} ms a pano by the events, "
              + (f"{k10_dev:.4f} ms by its kernel record" if k10_dev else
                 "its kernel record lost by the profiler"))
        require(np.array_equal(pak_sess.palette, pak_pal), "load_palette_from_pak differs")
        pak_np = pak_out.cpu().numpy()
        for b in (0, B - 1):
            require(np.array_equal(pak_np[..., b, :],
                                   pak_sess.render_host(frames[b], decode_rgb=True)),
                    f"the PAK palette's decode_rgb render, frame {b}, differs from host_remap")
        require(not np.array_equal(pak_np[..., 0, :], sess.render_host(frames[0], decode_rgb=True)),
                "the PAK palette's render equals the default palette's")
        phase(12, "load_palette_from_pak's palette drives a decode_rgb render (K2) bit-equal "
              f"to host_remap for frames 0 and {B - 1}")

        # ------------------------------------------------ where a replay's time goes
        chunk = frames[:B]
        packs = []
        for _ in range(3):
            t0 = time.perf_counter()
            batch_np = to_batch_layout(chunk)
            packs.append(1e3 * (time.perf_counter() - t0))
        # K1/K2 on the render's own operands by events (late in a run the
        # profiler can lose a profile's kernel records, PROFILE_TAIL_S)
        batch_dev = torch.from_numpy(batch_np).to(dev)
        src = batch_dev.reshape(-1, B)
        k = sess._kernel
        copy_ev = cuda_ms(lambda: torch.from_numpy(batch_np).to(dev), 3)
        raw = {"plain": lambda: remap.remap_gather(src, k.flat_idx, k.valid, k.background,
                                                   fill=True),
               "f_rubix": lambda: remap.remap_lut(src, k.flat_idx, k.valid, k.tint,
                                                  k.background, k.tint_lut, None, fill=True),
               "decode_rgb": lambda: remap.remap_lut(src, k.flat_idx, k.valid, k.tint,
                                                     k.background, None, k.rgb_lut, fill=True)}
        for name, kw, rec in (("plain", {}, "remap_gather"),
                              ("f_rubix", dict(rubix=True), "remap_lut"),
                              ("decode_rgb", dict(decode_rgb=True), "remap_lut")):
            kernel = "K1" if rec == "remap_gather" else "K2"
            kern_ev = cuda_ms(raw[name], ITERS)
            wall, recs, busy = profiled(lambda kw=kw: sess.render(batch_np, **kw), PROFILE_ITERS)
            copy = sum(t for n_, t in recs.items() if "memcpy" in n_.lower())
            kern_rec = sum(t for n_, t in recs.items() if rec in n_)
            n_frames, seconds, line = clocks[name]
            phase(12, f"timedemo {name}: \"{line}\" ({n_frames / seconds:.2f} frames/s, "
                  f"{1e3 * seconds:.3f} ms for {n_frames} frames); each part alone, a batch "
                  f"of {B}: the iterator's pack (to_batch_layout, host) {min(packs):.3f} ms "
                  "(of " + ", ".join(f"{x:.3f}" for x in packs) + f"), Session.render of the "
                  f"packed NumPy batch {wall:.3f} ms a call under the profiler, the device "
                  f"busy {busy:.3f} ms of it: the copy to the card {copy:.3f} ms by its "
                  f"record ({copy_ev:.3f} ms by the events), {kernel} "
                  + (f"{kern_rec:.4f} ms by its kernel record" if kern_rec else
                     "not recorded by the profiler") + f" ({kern_ev:.4f} ms by the events "
                  "on the render's operands)")
            window, spans, n_frames = timedemo_spans(sess, frames, B, kw)
            require(n_frames == REPLAY_N, f"timedemo {name} under the span probe counted "
                    f"{n_frames} frames")
            cover = {what: union_ms([(a, b) for w, a, b in spans if w == what])
                     for what in ("pack", "to_batch_layout", "copy", "kernel", "render call")}
            idle = window - union_ms([(a, b) for w, a, b in spans if w in ("copy", "kernel")])
            pace = max(("pack", "copy", "kernel"), key=cover.get)
            phase(12, f"timedemo {name} under the span probe, one call: the window "
                  f"{window:.3f} ms ({REPLAY_N / window * 1e3:.2f} frames/s); spans in ms "
                  "from its start, the iterator thread's packs and on the card each "
                  "render's copy and kernel: " + "; ".join(
                      f"{w} {a:.3f}-{b:.3f}" for w, a, b in sorted(spans, key=lambda x: x[1]))
                  + "; covered: " + ", ".join(f"{w} {t:.3f}" for w, t in cover.items())
                  + f" (the packs' padding {cover['pack'] - cover['to_batch_layout']:.3f})"
                  + f"; the card idle {idle:.3f} ms ({100 * idle / window:.1f} % of the "
                  f"window); the pace is set by the {pace}")
        del batch_dev, src
        phase(12, f"phase 12 took {time.perf_counter() - phase_t0:.3f} s")
    finally:
        shutil.rmtree(tmp)
    return launches


def timedemo_spans(sess, frames, batch, kw):
    """One ``timedemo`` call, its window cut into spans on the host clock:
    the iterator thread's packs (``FrameBatchIterator._pack``, the padding
    included) and the ``to_batch_layout`` call inside each, the main thread's ``Session.render`` calls, and on the card
    each render's copy (events around the copy of its frames, which this
    probe takes out of ``RemapKernel`` by wrapping ``remap.frames_tensor``)
    and its kernel (the copy's end to an event after the render returns).
    Card events are placed on the host clock from an anchor recorded on an
    idle card.  Returns (the window in ms, [(what, start ms, end ms)] from
    the window's start, the frames the clock counted)."""
    from blinky_tpu_torch.io import dataset
    from blinky_tpu_torch.kernels import remap

    host, marks = [], []
    pack0, layout0 = dataset.FrameBatchIterator._pack, dataset.to_batch_layout
    tensor0, render0 = remap.frames_tensor, sess.render

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def pack(self, i0):
        t0 = time.perf_counter()
        out = pack0(self, i0)
        host.append(("pack", t0, time.perf_counter()))
        return out

    def layout(chunk):
        t0 = time.perf_counter()
        out = layout0(chunk)
        host.append(("to_batch_layout", t0, time.perf_counter()))
        return out

    def frames_tensor(frames):
        t, is_rgba = tensor0(frames)
        start = event()
        t = t.to(sess.device)
        marks.append(("copy", start, event()))
        return t, is_rgba

    def render(frames, **k):
        t0 = time.perf_counter()
        out = render0(frames, **k)
        marks.append(("kernel", marks[-1][2], event()))
        host.append(("render call", t0, time.perf_counter()))
        return out

    torch.cuda.synchronize()
    t_anchor = time.perf_counter()
    anchor = event()
    anchor.synchronize()
    dataset.FrameBatchIterator._pack, dataset.to_batch_layout = pack, layout
    remap.frames_tensor, sess.render = frames_tensor, render
    try:
        _, clock = dataset.timedemo(sess, frames, batch=batch, **kw)
        t_end = time.perf_counter()
    finally:
        dataset.FrameBatchIterator._pack, dataset.to_batch_layout = pack0, layout0
        remap.frames_tensor = tensor0
        del sess.render
    torch.cuda.synchronize()
    to_ms = lambda t: 1e3 * (t - clock.start)  # noqa: E731
    dev_ms = lambda e: to_ms(t_anchor) + anchor.elapsed_time(e)  # noqa: E731
    spans = [(w, to_ms(a), to_ms(b)) for w, a, b in host]
    spans += [(w, dev_ms(a), dev_ms(b)) for w, a, b in marks]
    return to_ms(t_end), spans, clock.frames


def union_ms(spans):
    """The length of the union of (start, end) spans."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def calc_scale_of(lens, width_px, height_px):
    """The zoom scale of a lens's onload command (f_fov 180 without one)."""
    from blinky_tpu_torch.lensmap import Zoom, calc_scale

    zoom = (lens.onload or "f_fov 180").split()
    return calc_scale(Zoom(zoom[0][2:], *map(int, zoom[1:])), lens, width_px, height_px)


def _fast_screen(width_px, height_px, dev, frames_dev):
    """The batch through the built-in fast globe on Session(backend='torch')."""
    from blinky_tpu_torch.api import Session

    s = Session(width_px, height_px, device=dev, backend="torch")
    s.cmd("f_globe fast")
    return s.render(frames_dev)


def lane_chunked_err(got, ref):
    """max |got - ref| of two [n, B] int32 tensors, taken EQ_CHUNK lanes at a
    time so that the int64 copies stay small beside the tensors."""
    require(got.shape == ref.shape, f"shapes differ: {tuple(got.shape)}, {tuple(ref.shape)}")
    return max(int((got[:, lo:lo + EQ_CHUNK].long() - ref[:, lo:lo + EQ_CHUNK].long())
                   .abs().max()) for lo in range(0, got.shape[1], EQ_CHUNK))


def source_rows(idx, valid, rows, fill):
    """How many distinct source rows the valid pixels read under the fill
    or the clip rule: the rows a remap must read at least once."""
    i = idx[valid].long()
    if fill:
        i = torch.where(i < 0, i + rows, i)
        i = i[(i >= 0) & (i < rows)]
    else:
        i = i.clamp(0, rows - 1)
    return int(torch.unique(i).numel())


def time_variant(name, kernel, plain, nbytes):
    """Holds ``kernel()`` bit-equal to ``plain()``, then times both and
    prints the kernel's time beside its bound, *nbytes* at the card's
    memory rate."""
    require(torch.equal(kernel(), plain()), f"{name} differs from its plain version")
    ms, plain_ms = cuda_ms_pair(kernel, plain)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    phase(2, f"{name} at 1080p B={B_MAIN}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
          f"{nbytes} bytes, bound {bound_ms:.4f} ms, {100 * bound_ms / ms:.1f} % of it "
          f"({nbytes / (ms * 1e-3) / 1e9:.1f} GB/s); bit-equal")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)


PROFILE_TAIL_S = 0.3  # a pause before a profile stops
PROFILE_GAP_S = 0.1  # a pause between a profile's lead-in calls and its timed ones


def profiled(fn, iters, sync=True, tries=6):
    """Runs ``fn()`` *iters* times under ``torch.profiler`` after a warm-up
    call, synchronising after each call when *sync*.  Returns (host wall ms a
    call, {device record name: ms a call} from the CUPTI records of kernels,
    copies and fills, their sum: the device's busy ms a call).

    On an NVIDIA H100 80GB HBM3 with torch 2.11.0+cu128, a profile of 20
    launches loses the device records of its first launches, more of them
    the longer the process has run: one every 16-17 s, all 20 after about
    330 s (``python -m blinky_tpu_torch.bench.profiler_records``).  A pause
    before the profile starts does not help.  A pause at its end
    (``PROFILE_TAIL_S``) kept every record in all profiles after the first
    130 s.  A lead-in of 20 untimed launches, split from the timed ones by a
    pause, loses the records in their place, and kept every timed record up
    to about 350 s.  So the tries alternate: a tail alone, then a lead-in of
    ``4 * iters`` calls, ``PROFILE_GAP_S`` and a tail, with the allocator's
    cached blocks released before each.  A profile whose records look
    incomplete (none at all, or a record name seen a number of times that is
    no multiple of *iters*) is taken again, up to *tries* times."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        lead = 4 * iters if attempt % 2 else 0
        torch.cuda.empty_cache()
        fn()  # a warm-up call: its blocks are cached again, the rest stays free
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if lead:
                for _ in range(lead):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_GAP_S)
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
                if sync:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
            time.sleep(PROFILE_TAIL_S)
        # the program's spans (utils/timing.py::span) also land on the device's
        # timeline, each as an annotation as long as the work it holds: not
        # device work of their own
        recs = sorted((e.time_range.start, e.time_range.elapsed_us(), e.name)
                      for e in prof.events() if e.device_type.name == "CUDA"
                      and not getattr(e, "is_user_annotation", False))
        if lead and len(recs) > 1:
            # the timed calls' records: those after the lead-in's pause, the
            # widest gap, unless the lead-in left no record
            gaps = [b[0] - a[0] for a, b in zip(recs, recs[1:])]
            i = max(range(len(gaps)), key=gaps.__getitem__)
            if gaps[i] >= 0.9 * PROFILE_GAP_S * 1e6:
                recs = recs[i + 1:]
        dev_ms, seen = {}, {}
        for _, us, name in recs:
            dev_ms[name] = dev_ms.get(name, 0.0) + us / 1e3 / iters
            seen[name] = seen.get(name, 0) + 1
        if dev_ms and all(n % iters == 0 for n in seen.values()):
            break
    require(dev_ms, f"torch.profiler recorded no device work in {tries} profiles")
    return wall, dev_ms, sum(dev_ms.values())


def host_ms(fn):
    """Host wall-clock milliseconds of one call of ``fn()``, no synchronise."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def register_path(ingest, fn):
    """``fn()`` with K10 held on its register path, whatever the rows."""
    ring = ingest.ring_path
    ingest.ring_path = lambda *a: False
    try:
        return fn()
    finally:
        ingest.ring_path = ring


def cuda_ms_pair(kernel, plain):
    """(kernel ms, plain ms) per call, timed in turns: plain, kernel, kernel,
    plain; each figure the mean of its two runs."""
    from blinky_tpu_torch.bench.sol import cuda_ms

    p1 = cuda_ms(plain, ITERS)
    k1 = cuda_ms(kernel, ITERS)
    k2 = cuda_ms(kernel, ITERS)
    p2 = cuda_ms(plain, ITERS)
    return (k1 + k2) / 2, (p1 + p2) / 2


# chip_smoke.py --sweep: K5's and K7's tuning constants, each configuration
# built from the sources with nvcc -D (all builds started at once) and timed
# in turns against the others on phase 6's operands
K5_SWEEP = [{}, {"K5_POSES_PER_BLOCK": 8}, {"K5_POSES_PER_BLOCK": 2},
            {"K5_POSES_PER_BLOCK": 16}, {"K5_TILE_RUNS": 8}, {"K5_TILE_RUNS": 32},
            {"K5_TILE_RUNS": 256}, {"K5_POSE_GROUP": 1}, {"K5_POSE_GROUP": 4},
            {"K5_THREADS": 512}]
K7_SWEEP = [{}] + [{"K7_COLUMN_LOADS": n} for n in (2, 4, 16)]
# K7's long-row path: 64-byte chunks of a row a block (K7_ROW_CHUNKS_U8,
# K7_ROW_CHUNKS_RGBA) and which grid index runs fastest (K7_ROW_ORDER 0: the
# chunk, 1: the texel tile), against the vector path; the source's defaults
# first and again by name, so that the two readings of one build show the
# noise
K7_ROWS_SWEEP = [{}, {"K7_ROW_CHUNKS_U8": 2, "K7_ROW_CHUNKS_RGBA": 4, "K7_ROW_ORDER": 0},
                 {"K7_ROW_CHUNKS_U8": 1, "K7_ROW_CHUNKS_RGBA": 1},
                 {"K7_ROW_CHUNKS_U8": 4, "K7_ROW_CHUNKS_RGBA": 2},
                 {"K7_ROW_ORDER": 1},
                 {"K7_ROW_CHUNKS_U8": 4, "K7_ROW_CHUNKS_RGBA": 2, "K7_ROW_ORDER": 1}]
# its shapes: (kind, B, the width of the array B is a slice of), at 1080p
K7_ROWS_SHAPES = [("u8", 64, 64), ("u8", 128, 128), ("u8", 256, 256), ("u8", 1024, 1024),
                  ("u8", 2048, 2048), ("u8", 1024, 2048), ("rgba", 32, 32), ("rgba", 64, 64),
                  ("rgba", 256, 256)]
# K10's ring path (csrc/ingest.cu): the stages' bytes and count of the four-
# and the one-tap ring, the cap on a stage's outputs, the consumer and
# producer warps; the source's defaults first and again by name, so that the
# two readings of one build show the noise
K10_RING_SWEEP = [{}, {"K10_RING_STAGES_K4": 2, "K10_RING_STAGE_BYTES_K4": 65536},
                  {"K10_RING_STAGES_K4": 3, "K10_RING_STAGE_BYTES_K4": 49152},
                  {"K10_RING_STAGES_K4": 4, "K10_RING_STAGE_BYTES_K4": 40960},
                  {"K10_RING_STAGE_BYTES_K4": 57344}, {"K10_RING_STAGE_BYTES_K4": 81920},
                  {"K10_RING_STAGE_BYTES_K4": 90112}, {"K10_RING_STAGES_K1": 4},
                  {"K10_RING_STAGE_BYTES_K1": 65536}, {"K10_RING_MAX_RUN": 128},
                  {"K10_RING_CONSUMERS": 12}, {"K10_RING_PRODUCERS": 6}]
# its shapes: the 360 cell's compact tables (4096x2048 panos, 720 plates,
# panini 1280x720) at these batches, for the threshold; then the other modes
# and the nearest tables at the cell's B
K10_RING_BATCHES = (16, 32, 48, 64, 96, 128, 256)
K10_RING_MODES = ("fused", "fused + tint", "faces", "compact, nearest", "fused, nearest")
# cudaLimitMaxL2FetchGranularity in cudaLimit
L2_FETCH_LIMIT = 5


def build_variants(specs):
    """Builds every configuration of *specs* (``{source stem: [configs]}``,
    each list led by ``{}``, the package's own build) from ``csrc/<stem>.cu``
    with nvcc -D, all at once.  Returns ``{stem: [(config, library)]}``."""
    from blinky_tpu_torch.kernels import _build

    home = _build.library()
    procs = []
    for name, configs in specs.items():
        for cfg in configs[1:]:
            # a name of its own a configuration: dlopen hands back a library
            # already loaded from the same path
            stem = "_".join(f"{k}{v}" for k, v in cfg.items())
            lib = _build.BUILD_DIR / f"sweep_{name}_{stem}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in cfg.items()),
                   "-o", str(lib), str(_build.CSRC / f"{name}.cu"),
                   str(_build.CSRC / "remap_gather.cu")]
            procs.append((name, cfg, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                           stderr=subprocess.STDOUT, text=True)))
    variants = {name: [({}, home)] for name in specs}
    for name, cfg, lib, proc in procs:
        log = proc.communicate()[0]
        require(proc.returncode == 0, f"nvcc {name}.cu {cfg}:\n{log}")
        variants[name].append((cfg, bind_library(lib)))
    return variants


def bind_library(path):
    """A new ctypes handle on the kernel library at *path*, its entry points
    bound as ``kernels/_build.py`` binds them."""
    import ctypes

    from blinky_tpu_torch.kernels import _build

    cdll = ctypes.CDLL(str(path))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(cdll, fn):
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
    cdll.blinky_error_string.argtypes = [ctypes.c_int]
    cdll.blinky_error_string.restype = ctypes.c_char_p
    return cdll


def time_variants(variants, call, what, ref=None):
    """Each of *variants* (``[(config or label, library)]``) timed on
    ``call()``, in turns forwards and backwards, each held equal to *ref*
    (by default the first variant's output).  Returns their mean ms."""
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.kernels import _build

    home = _build._lib
    times = {i: [] for i in range(len(variants))}
    try:
        for order in (list(times), list(times)[::-1]):
            for i in order:
                _build._lib = variants[i][1]
                got = call()
                if ref is None:
                    ref = got
                require(torch.equal(got, ref), f"{what}: {variants[i][0]} differs")
                del got
                times[i].append(cuda_ms(call, 20))
    finally:
        _build._lib = home
    out = []
    for i, ts in times.items():
        cfg = variants[i][0]
        label = (cfg if isinstance(cfg, str) else ", ".join(f"{k}={v}" for k, v in cfg.items())
                 or "the source's defaults")
        out.append(float(np.mean(ts)))
        print(f"{what}: {label}: {out[-1]:.4f} ms; bit-equal", flush=True)
    return out


def sweep():
    """Times every configuration of K5_SWEEP on the phase 6 tables (u8 and
    RGBA, render scales 1 and 2) and of K7_SWEEP on the one-pose slices,
    each bit-checked against the package's build; then the package's K7 on
    the one-pose slices under each L2 fetch granularity limit; then
    K7_ROWS_SWEEP (:func:`sweep_rows`)."""
    import ctypes
    import glob
    import os

    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench.posed import posed_poses
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
    from blinky_tpu_torch.kernels import posed
    from blinky_tpu_torch.lensmap.builder import rays_to_lensmap_torch
    from blinky_tpu_torch.palette import MAX_PLATES, rgba_lut

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    variants = build_variants({"posed": K5_SWEEP, "layout": K7_SWEEP})
    dev = torch.device("cuda")
    S, batch = 1080, POSED_B
    frames = torch.from_numpy(synthetic_cubemap_batch(S, batch)).to(dev)
    sess = Session(1920, 1080, device=dev)
    poses = posed_poses(batch)
    bases_np = posed.bases_from_pose_track(poses)
    lut = torch.from_numpy(rgba_lut(sess.palette).view(np.int32)).to(dev)
    rgba = lut[frames.long()]
    for k in (1, 2):
        sess.render_posed(frames, poses, render_scale=k)
        kern = sess._posed_cache[1]
        _, bases, _ = posed.prep_posed_inputs(frames, bases_np, S, kern.background, dev)
        parts = [rays_to_lensmap_torch(kern.globe, kern.ray_table.vx, kern.ray_table.vy,
                                       kern.ray_table.vz, kern.ray_table.lens_valid, S,
                                       kern.numcells, kern.cell_size, kern.pad_size,
                                       view_basis=bases[lo:lo + CHUNK])
                 for lo in range(0, batch, CHUNK)]
        idx = torch.cat([p_["flat_idx"] for p_ in parts]).contiguous()
        valid = torch.cat([p_["valid"] for p_ in parts]).contiguous()
        del parts
        for kind, fr in (("u8", frames), ("rgba", rgba)):
            src = posed.posed_layout(fr, MAX_PLATES)
            bg = kern.background if kind == "u8" else lut[kern.background.long()]
            time_variants(variants["posed"], lambda: posed.gather_posed(src, idx, valid, bg, k),
                          f"K5 {kind} k={k} 1080p B={batch}")
            del src
        del idx, valid
    for kind, fr in (("u8", frames), ("rgba", rgba)):
        x = fr[..., :1]
        time_variants(variants["layout"], lambda: posed.posed_layout(x, MAX_PLATES),
                      f"K7 {kind} one-pose slice [..., 0:1]")
        lib_ms = cuda_ms(lambda: x.permute(3, 0, 1, 2).contiguous(), 20)
        print(f"K7 {kind} one-pose slice: permute().contiguous() {lib_ms:.4f} ms", flush=True)
    # the L2 fetch granularity limit: a hint the CUDA runtime may clamp, read back after
    # each setting
    from torch.utils.cpp_extension import CUDA_HOME
    found = sorted(glob.glob(os.path.join(CUDA_HOME or "/usr/local/cuda", "lib64", "libcudart.so*")))
    require(found, "no libcudart under the CUDA toolkit")
    cudart = ctypes.CDLL(found[-1])
    cudart.cudaDeviceGetLimit.argtypes = [ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    cudart.cudaDeviceSetLimit.argtypes = [ctypes.c_int, ctypes.c_size_t]
    cudart.cudaDeviceGetLimit.restype = cudart.cudaDeviceSetLimit.restype = ctypes.c_int
    value = ctypes.c_size_t(0)
    require(cudart.cudaDeviceGetLimit(ctypes.byref(value), L2_FETCH_LIMIT) == 0,
            "cudaDeviceGetLimit failed")
    default = value.value
    for limit in (32, 64, 128, default):
        require(cudart.cudaDeviceSetLimit(L2_FETCH_LIMIT, limit) == 0,
                "cudaDeviceSetLimit failed")
        cudart.cudaDeviceGetLimit(ctypes.byref(value), L2_FETCH_LIMIT)
        for kind, fr in (("u8", frames), ("rgba", rgba)):
            x = fr[..., :1]
            ms = cuda_ms(lambda: posed.posed_layout(x, MAX_PLATES), 20)
            lib_ms = cuda_ms(lambda: x.permute(3, 0, 1, 2).contiguous(), 20)
            print(f"L2 fetch granularity limit {limit} (reads back {value.value}, default "
                  f"{default}): K7 {kind} one-pose slice {ms:.4f} ms, permute().contiguous() "
                  f"{lib_ms:.4f} ms", flush=True)
    del frames, rgba, sess
    torch.cuda.empty_cache()
    return sweep_rows()


def sweep_rows():
    """K7's long-row path: each configuration of K7_ROWS_SWEEP on each of
    K7_ROWS_SHAPES (1080p plates, six planes, random bytes made on the card),
    beside the vector path (the package's ``blinky_posed_layout``), each held
    equal to the plain version and printed with its share of the byte bound
    (the frames read once, the pose-major array written once)."""
    from blinky_tpu_torch.kernels import _build, posed
    from blinky_tpu_torch.palette import MAX_PLATES

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = build_variants({"layout": K7_ROWS_SWEEP})["layout"]
    # the vector path through a handle of its own on the package's library
    vec = bind_library(_build.LIBRARY)
    variants = [("vector path", vec)] + [
        (", ".join(f"{k}={v}" for k, v in cfg.items()) or "long-row path, the source's defaults",
         lib) for cfg, lib in rows]
    dev = torch.device("cuda")
    S = 1080
    choose = posed.long_row_path
    posed.long_row_path = lambda *a: _build._lib is not vec
    summary = {}
    try:
        for kind, batch, width in K7_ROWS_SHAPES:
            el = 4 if kind == "rgba" else 1
            gen = torch.Generator(dev).manual_seed(batch + width)
            full = torch.randint(0, 256, (MAX_PLATES, S, S, width * el), dtype=torch.uint8,
                                 device=dev, generator=gen)
            full = full.view(torch.int32) if kind == "rgba" else full
            x = full[..., :batch]
            what = f"K7 {kind} B={batch}" + (f" of {width}" if width > batch else "")
            ms = time_variants(variants, lambda: posed.posed_layout(x, MAX_PLATES), what,
                               posed.posed_layout_plain(x, MAX_PLATES))
            nbytes = 2 * x.numel() * el
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            summary[what] = {label: round(100 * bound / m, 2)
                             for (label, _), m in zip(variants, ms)}
            print(f"{what}: {nbytes} bytes, bound {bound:.4f} ms; shares of it (%): "
                  f"{summary[what]}", flush=True)
            del full, x
            torch.cuda.empty_cache()
    finally:
        posed.long_row_path = choose
    print(json.dumps({"k7_rows_sweep": summary}), flush=True)
    return 0


def sweep_k10():
    """K10's ring path: each configuration of K10_RING_SWEEP beside the
    register path (the package's ``blinky_equirect_gather``) on the 360
    cell's compact tables at each of K10_RING_BATCHES and, at B = 128, on
    K10_RING_MODES; each held equal to the plain version and printed with
    its share of the byte bound (the distinct pano rows the outputs that
    read any name, the tables, the per-output operands, the outputs)."""
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.kernels import _build, ingest

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    rings = build_variants({"ingest": K10_RING_SWEEP})["ingest"]
    reg = bind_library(_build.LIBRARY)  # the register path through a handle of its own
    variants = [("register path", reg)] + [
        (", ".join(f"{k}={v}" for k, v in cfg.items()) or "ring, the source's defaults", lib)
        for cfg, lib in rings]
    dev = torch.device("cuda")
    sess = Session(EQ_W, EQ_H, platesize=EQ_S, device=dev)
    gen = torch.Generator(dev).manual_seed(10)
    sess.render_equirect(torch.randint(-2**31, 2**31 - 1, (PANO_H, PANO_W, 4), dtype=torch.int32,
                                       device=dev, generator=gen).view(torch.uint32))
    k = sess._kernel
    tr, tm = k.tint_rgb_mask
    tables = {}
    for bilinear in (True, False):
        ing = ingest.EquirectIngest(PANO_H, PANO_W, EQ_S, globe=sess.globe, bilinear=bilinear,
                                    device=dev)
        sub = ingest.CompactEquirectChain(ing, k).sub.device_tables()
        fused = ingest.EquirectScreenKernel(ing, k)
        full = ing.device_tables()
        tag = "" if bilinear else ", nearest"
        w_of = (lambda w: w) if bilinear else (lambda w: None)
        tables["compact" + tag] = (sub[0], w_of(sub[1]), dict(plate_mask=sub[2]), 4, sub[2] != 0)
        tables["fused" + tag] = (fused.idx, w_of(fused.w),
                                 dict(valid=k.valid, bg=k.background_rgba), 5, k.valid)
        if bilinear:
            tables["fused + tint"] = (fused.idx, fused.w,
                                      dict(valid=k.valid, bg=k.background_rgba, tint_rgb=tr,
                                           tint_mask=tm), 10, k.valid)
            tables["faces"] = (full[0], full[1], dict(plate_mask=full[2]), 4, full[2] != 0)
    shapes = [("compact", b) for b in K10_RING_BATCHES] + [(m, PANO_B) for m in K10_RING_MODES]
    choose = ingest.ring_path
    ingest.ring_path = lambda *a: _build._lib is not reg
    summary = {}
    try:
        for name, batch in shapes:
            idx, w, kw, n_ops, keep = tables[name]
            src = torch.randint(-2**31, 2**31 - 1, (PANO_H * PANO_W, batch), dtype=torch.int32,
                                device=dev, generator=gen)
            what = f"K10 {name} B={batch} ({batch * 4}-byte rows)"
            ms = time_variants(variants, lambda: ingest.equirect_gather(src, idx, w, **kw), what,
                               ingest.equirect_gather_plain(src, idx, w, **kw))
            rows = int(torch.unique(idx[:, keep]).numel())
            n = idx.shape[1]
            nbytes = (rows * batch * 4 + idx.numel() * 4 + (w.numel() * 4 if w is not None else 0)
                      + n * n_ops + n * batch * 4)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            summary[what] = {label: [round(m, 4), round(100 * bound / m, 2)]
                             for (label, _), m in zip(variants, ms)}
            print(f"{what}: {rows} distinct pano rows, {nbytes} bytes, bound {bound:.4f} ms; "
                  f"(ms, % of it): {summary[what]}", flush=True)
            del src
            torch.cuda.empty_cache()
    finally:
        ingest.ring_path = choose
    print(json.dumps({"k10_ring_sweep": summary}), flush=True)
    return 0


# phase 13: the bench suite's entry point.  Each run is a process of its
# own, as a user starts it; these bound each run (the quick suite takes a
# few minutes) and the batch of the small calibrate probe
BENCH_TIMEOUT_S = 600
SMALL_PROBE_B = 128
# the kernels each run must have launched
BENCH_PATHS = {
    "headline": ("remap_gather",),
    "--all --quick": ("remap_gather", "posed_gather", "static_ray_posed", "posed_layout",
                      "lensmap_resolve", "equirect_gather"),
    "--sol": ("onehot_gather", "stream_read"),
    "--check --configs 0-3": ("remap_gather", "lensmap_resolve"),
    "calibrate probe": ("remap_gather",),
}


def bench_phase(dev):
    """Phase 13: ``python -m blinky_tpu_torch.bench`` as a user runs it, in
    processes of its own.  Returns the kernels' launches summed over every
    process of the phase, which the kernels line adds to each kernel's own
    path's."""
    import math
    import shutil
    import tempfile

    from blinky_tpu_torch import budget
    from blinky_tpu_torch.bench import autobatch, calibrate, check
    from blinky_tpu_torch.bench.__main__ import LAUNCHES_ENV, launch_counts

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="blinky_bench_"))
    free, total = torch.cuda.mem_get_info(dev)
    phase(13, f"this process holds {torch.cuda.memory_reserved(dev)} bytes of the card; "
          f"{free} of {total} bytes free for the bench's processes")
    runs = {}

    def counted(name, fn):
        """Run *fn* with every process it starts recording its launches in a
        file of its own; require the run's kernels launched."""
        path = tmp / f"{len(runs)}.jsonl"
        os.environ[LAUNCHES_ENV] = str(path)
        try:
            t0 = time.perf_counter()
            out = fn()
            seconds = time.perf_counter() - t0
        finally:
            del os.environ[LAUNCHES_ENV]
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        n = {k: sum(line["launches"][k] for line in lines) for k in launch_counts()}
        runs[name] = n
        for kernel in BENCH_PATHS[name]:
            require(n[kernel] >= 1, f"bench {name}: {kernel} was not launched")
        phase(13, f"{name}: {len(lines)} processes in {seconds:.1f} s, launches "
              f"{ {k: v for k, v in n.items() if v} }")
        return out

    def bench(*flags, ok=(0,)):
        proc = subprocess.run([sys.executable, "-m", "blinky_tpu_torch.bench", *flags],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=BENCH_TIMEOUT_S)
        require(proc.returncode in ok, f"bench {' '.join(flags)} exited "
                f"{proc.returncode}: {proc.stderr[-3000:]}")
        return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]

    try:
        # ------------------------------------------------ the headline
        (head,) = counted("headline", bench)
        texels = head["source_rows"]
        src_lane = autobatch.texels_bytes_per_lane(texels)
        screen = budget.screen_bytes_per_lane(1920, 1080)
        derived = budget.feasible_batch(src_lane, screen,
                                        budget=autobatch.effective_budget_bytes(dev),
                                        quantum=autobatch.QUANTUM)
        require(head["metric"] == "warped_1080p_frames_per_sec_per_chip" and head["equal"],
                f"headline: {head}")
        require(head["batch"] == derived, f"headline batch {head['batch']}, the planner "
                f"derives {derived} for this card")
        bound_ms = head["bound_bytes"] / HBM_BYTES_PER_S * 1e3
        phase(13, f"headline {head['config']}: {head['value']} frames/s, "
              f"{head['ms_per_batch']:.4f} ms a batch, {head['gbps']:.1f} GB/s; K1 at "
              f"B={head['batch']} (the planner's: {src_lane} + {screen} bytes a lane, "
              f"EFFECTIVE_FRACTION {autobatch.EFFECTIVE_FRACTION} of "
              f"{autobatch.device_hbm_bytes(dev)} bytes) against its byte bound "
              f"{bound_ms:.4f} ms ({head['bound_bytes']} B): "
              f"{100 * bound_ms / head['ms_per_batch']:.1f} %")

        # ------------------------------------------------ the quick suite
        results = counted("--all --quick", lambda: bench("--all", "--quick"))
        require(sorted(r["config"] for r in results) == list(range(8)),
                f"--all --quick gave configs {[r['config'] for r in results]}")
        for r in results:
            leaves = dict(check._walk(r))
            missing = [k for k, v in leaves.items() if check._kind(k) and v is None]
            errors = [k for k in leaves if k.endswith("_error")]
            require(not missing and not errors, f"config {r['config']}: not measured "
                    f"{missing}, errors { {k: leaves[k] for k in errors} }")
            require(all(v for k, v in leaves.items() if k.rsplit('.', 1)[-1] == "exact"),
                    f"config {r['config']}: exact is False")
            phase(13, f"--all --quick config {r['config']}: {json.dumps(r)}")

        # ------------------------------------------------ the probes
        probes = counted("--sol", lambda: bench("--sol"))
        for p_ in probes:
            if p_["probe"] in ("onehot_gather", "stream_read"):
                require(p_["equal"], f"--sol {p_['probe']} differs from its plain version")
        phase(13, "--sol: " + ", ".join(f"{p_['probe']} {p_['ms']:.4f} ms" for p_ in probes))

        # ------------------------------------------------ the gate
        rc = {}

        def gate():
            lines = bench("--check", "--configs", "0-3", ok=(0, 1))
            rc["verdict"] = lines[-1]
            return lines

        counted("--check --configs 0-3", gate)
        v = rc["verdict"]
        require(v.get("metric") == "bench_check" and v["status"] in ("pass", "fail"),
                f"--check: {v}")
        phase(13, f"--check --configs 0-3 against {check.BASELINE_PATH.relative_to(ROOT)}: "
              f"{v['status']}; failures {v['failures']}")

        # ------------------------------------------------ calibrate probes
        per_lane = calibrate.probe_layout_bytes()
        past = math.ceil(autobatch.device_hbm_bytes(dev) / per_lane / 128) * 128 + 128
        ran = counted("calibrate probe", lambda: (
            calibrate._spawn_probe(SMALL_PROBE_B, BENCH_TIMEOUT_S),
            calibrate._spawn_probe(past, BENCH_TIMEOUT_S)))
        require(ran == (True, False), f"calibrate probes B={SMALL_PROBE_B} and B={past} "
                f"(past {autobatch.device_hbm_bytes(dev)} bytes): {ran}, expected "
                "(ran, out of memory)")
        phase(13, f"calibrate probes: B={SMALL_PROBE_B} ran; B={past} ({per_lane * past} "
              f"bytes) ran out of memory; phase 13 took {time.perf_counter() - phase_t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {k: sum(n[k] for n in runs.values()) for k in launch_counts()}


# phase 14: the mesh (blinky_tpu_torch.parallel), the CLI and the viewer.  The
# CLI's comparisons run at a size the CPU finishes in seconds; one 1080p
# reproject is timed.
MESH_B = 64
CLI_S, CLI_W, CLI_H, CLI_FRAMES = 48, 64, 48, 6
CLI_1080_FRAMES = 16
VIEW_W, VIEW_H, VIEW_S = 640, 480, 256
CLI_TIMEOUT_S = 300
# the CLI's outputs through the float32 lens stage on the card, held to the
# same command on the CPU by the port's rules for two lens stages: render_posed
# 0.02 of the run's pixels, the fused sweep 0.06 of a step's
# (tests/test_torch_posed.py)
FLOAT_STAGE = {"reproject --follow-poses": 0.02, "sweep": 0.06}


def mesh_phase(dev, frames, frames_dev, lm):
    """Phase 14: the sharded functions at the main path's sizes on a logical
    (4, 2) mesh of the card, a two-level (2, 2, 2) one and the mesh of the
    cards there are, each bit-equal to its unsharded path; the split's cost;
    both weak scalings; the CLI in processes of its own, each output byte-equal
    to the same command on the CPU; and the viewer from its start to
    ``device_ready``.  Returns the kernels' launches in this process's run of
    the phase."""
    import shutil
    import socket
    import tempfile
    import urllib.request

    from blinky_tpu_torch import parallel
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench.__main__ import kernel_wrappers
    from blinky_tpu_torch.bench.sol import cuda_ms
    from blinky_tpu_torch.bench.throughput import (
        device_pano, device_source, run_posed_sharded_scaling, run_sharded_scaling,
    )
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap
    from blinky_tpu_torch.io.gif import decode_gif
    from blinky_tpu_torch.io.png import encode_png
    from blinky_tpu_torch.kernels import ingest, posed, remap, static_ray
    from blinky_tpu_torch.kernels.remap import host_array
    from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
    from blinky_tpu_torch import globes, lenses
    from blinky_tpu_torch.viewer import Viewer

    phase_t0 = time.perf_counter()
    torch.cuda.empty_cache()
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    H, W, S = lm.height_px, lm.width_px, lm.platesize
    B = frames_dev.shape[-1]

    def equal(a, b):
        bits = (lambda t: t.view(torch.int32) if t.dtype == torch.uint32 else t)
        return torch.equal(bits(a), bits(b))

    # ------------------------------------------------ a: the sharded remap
    logical = parallel.make_mesh(4, 2, devices=[dev] * 8)
    two_level = parallel.make_slice_mesh(2, 2, 2, devices=[dev] * 8)
    cards = parallel.make_mesh(devices=parallel.visible_devices(dev.type)) \
        if dev.type == "cuda" else parallel.make_mesh(1, 1, devices=[dev])
    sess = Session(W, H, device=dev)
    kernel = remap.RemapKernel(lm, sess.palette, device=dev)
    sources = {
        "u8": (frames_dev, {}), "u8 f_rubix": (frames_dev, dict(rubix=True)),
        "u8 decode_rgb": (frames_dev, dict(decode_rgb=True)),
        "expanded": (device_source(S, B, True, False, device=dev), dict(rubix=True)),
        "RGBA": (device_source(S, B, False, True, device=dev).view(torch.uint32), {}),
    }
    checked = []
    for kind, (src, kw) in sources.items():
        want = kernel(src, **kw)
        for name, mesh in (("(4, 2) logical", logical), ("(2, 2, 2) logical", two_level),
                           (f"{cards.shape} of the cards", cards)):
            got = parallel.remap_sharded(kernel, src, mesh, **kw)
            require(equal(got.to(dev), want),
                    f"remap_sharded {kind} on the {name} mesh differs from RemapKernel")
            checked.append(f"{kind} {name}")
        del want, got
    phase(14, f"remap_sharded at {W}x{H} B={B} bit-equal to RemapKernel on the same frames: "
          f"{len(checked)} cases (u8, f_rubix, decode_rgb, expanded, RGBA on the (4, 2) and "
          f"(2, 2, 2) logical meshes of {dev} and the mesh of the cards there are, "
          f"{cards.shape})")

    # the split's cost: remap_sharded on the logical mesh against the
    # unsharded render of the same frames, by events and by the wall clock
    plain_k = lambda: kernel(frames_dev)  # noqa: E731
    sharded = lambda: parallel.remap_sharded(kernel, frames_dev, logical)  # noqa: E731
    walls = {}
    for name, fn in (("unsharded", plain_k), ("sharded", sharded), ("sharded again", sharded),
                     ("unsharded again", plain_k)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
    ev_plain, ev_shard = cuda_ms(plain_k, ITERS), cuda_ms(sharded, ITERS)
    copy_ms = cuda_ms(lambda: parallel.shard_frames(frames_dev, logical), ITERS)
    phase(14, f"the split's cost at {W}x{H} B={B} u8 on the (4, 2) logical mesh of one "
          f"card: remap_sharded {ev_shard:.4f} ms by the events ({len(logical.devices.flat)} "
          f"cells, each K1 on its rows and lanes, after shard_frames' lane copies "
          f"{copy_ms:.4f} ms), the unsharded render {ev_plain:.4f} ms; wall clock "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in walls.items()))

    # ------------------------------------------------ b: the sharded build
    g = globes.get("cube")
    for lens_name, zoom in (("panini", ("fov", 180)), ("stereographic", ("fov", 300))):
        lens = lenses.get(lens_name, g)
        scale = calc_scale(Zoom(*zoom), lens, W, H)
        got = parallel.build_lensmap_sharded(lens, g, scale, W, H, logical, platesize=S)
        want = build_lensmap(lens, g, scale, W, H, S, backend="torch", device=dev)
        for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
            require(equal(getattr(got, f).to(dev), getattr(want, f)),
                    f"build_lensmap_sharded {lens_name}: {f} differs from the unsharded build")
    phase(14, f"build_lensmap_sharded (panini + cube f_fov 180, stereographic f_fov 300) at "
          f"{W}x{H} on the (4, 2) logical mesh: every table bit-equal to "
          "build_lensmap(backend='torch') (the lens stage on each row block, then K8)")

    # ------------------------------------------------ c: the posed paths
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    rng = np.random.default_rng(14)
    bases = posed.bases_from_pose_track(np.stack(
        [rng.uniform(-30, 30, B), rng.uniform(0, 360, B), rng.uniform(-10, 10, B)], axis=1))
    pk = posed.PosedRemapKernel(lens, g, W, H, scale, platesize=S, device=dev)
    sk = static_ray.StaticRayPosedKernel(lens, g, W, H, scale, platesize=S, device=dev)
    for name, fn, k in (("posed_remap_sharded", parallel.posed_remap_sharded, pk),
                        ("static_ray_posed_sharded", parallel.static_ray_posed_sharded, sk)):
        want = k(frames_dev, bases)
        for mname, mesh in (("(4, 2)", logical), ("(2, 2, 2)", two_level)):
            require(equal(fn(k, frames_dev, bases, mesh).to(dev), want),
                    f"{name} on the {mname} mesh differs from the unsharded kernel")
        del want
    phase(14, f"posed_remap_sharded and static_ray_posed_sharded at {W}x{H} B={B} (the poses "
          "over the data shards: K7 and K6 a shard) bit-equal to PosedRemapKernel and "
          "StaticRayPosedKernel on the (4, 2) and (2, 2, 2) logical meshes")

    # ------------------------------------------------ d: the equirect paths
    panos = device_pano(PANO_H, PANO_W, PANO_B, device=dev)
    eq = Session(EQ_W, EQ_H, platesize=EQ_S, device=dev)
    ing = ingest.EquirectIngest(PANO_H, PANO_W, EQ_S, globe=eq.globe, device=dev)
    faces = parallel.ingest_equirect_sharded(ing, panos, logical)
    require(equal(faces.to(dev), ing(panos)), "ingest_equirect_sharded differs from the ingest")
    del faces
    ek = ingest.EquirectScreenKernel(ing, remap.RemapKernel(eq.lensmap, eq.palette, device=dev))
    for rubix in (False, True):
        require(equal(parallel.equirect_screen_sharded(ek, panos, logical, rubix=rubix).to(dev),
                      ek(panos, rubix=rubix)),
                f"equirect_screen_sharded rubix={rubix} differs from the fused kernel")
    phase(14, f"ingest_equirect_sharded and equirect_screen_sharded (plain and f_rubix) at "
          f"{PANO_W}x{PANO_H} -> S={EQ_S} -> {EQ_W}x{EQ_H} B={PANO_B} on the (4, 2) logical "
          "mesh bit-equal to EquirectIngest and EquirectScreenKernel (K10 a shard)")
    del panos, ing, ek, eq

    # ------------------------------------------------ e: Session.render_sharded
    sess.cmd("f_rubix")
    require(equal(sess.render_sharded(frames_dev, logical).to(dev), sess.render(frames_dev)),
            "Session.render_sharded (f_rubix) differs from Session.render")
    sess.cmd("f_rubix")
    require(equal(sess.render_sharded(frames, cards).to(dev), sess.render(frames)),
            "Session.render_sharded of the NumPy batch differs from Session.render")
    phase(14, "Session.render_sharded bit-equal to Session.render (f_rubix on the card's "
          "batch over the (4, 2) logical mesh; the NumPy batch over the cards' mesh)")
    del sources, sess, kernel, pk, sk
    torch.cuda.empty_cache()

    # ------------------------------------------------ f: the scalings
    for devs, what in ((None if dev.type == "cuda" else [dev], "the cards there are"),
                       ([dev] * 4, "4 logical shards of one card")):
        rows = run_sharded_scaling(width=640, height=480, platesize=480, per_device_batch=32,
                                   iters=3, reps=2, devices=devs)
        rows_p = run_posed_sharded_scaling(width=320, height=240, platesize=240,
                                           per_device_poses=4, iters=2, reps=2, devices=devs)
        require(all(r["equal"] for r in rows + rows_p), f"a sharded scaling over {what} "
                "differs from the unsharded kernel")
        phase(14, f"run_sharded_scaling over {what}: " + "; ".join(
            f"{r['devices']} ({r['mesh']}) B={r['batch']} {r['fps']:.1f} frames/s" for r in rows)
            + "; run_posed_sharded_scaling: " + "; ".join(
            f"{r['devices']} B={r['poses']} {r['fps']:.1f} frames/s" for r in rows_p))

    # ------------------------------------------------ g: the CLI, in processes
    tmp = Path(tempfile.mkdtemp(prefix="blinky_cli_"))
    card = dev.type

    def spawn(args, out):
        return subprocess.Popen([sys.executable, "-m", "blinky_tpu_torch.cli", *args,
                                 "--device", card], cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True), out

    def on_cpu(args):
        """The same command in this process on the CPU, its stdout captured."""
        import contextlib
        import io

        from blinky_tpu_torch import cli

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*args, "--device", "cpu"])
        return rc, buf.getvalue()

    try:
        demo, demo1080 = tmp / "demo.npz", tmp / "demo1080.npz"
        require(on_cpu(["demo-synth", "--frames", str(CLI_FRAMES), "--platesize", str(CLI_S),
                        "--out", str(demo)])[0] == 0, "demo-synth on the CPU")
        require(on_cpu(["demo-synth", "--frames", str(CLI_1080_FRAMES), "--platesize",
                        str(S), "--out", str(demo1080)])[0] == 0, "the 1080p demo-synth")
        size = ["--width", str(CLI_W), "--height", str(CLI_H)]
        rep = ["reproject", "--demo", str(demo), *size, "--batch", "3"]
        cmds = {
            "demo-synth": ["demo-synth", "--frames", str(CLI_FRAMES), "--platesize",
                           str(CLI_S), "--out"],
            "reproject": [*rep, "--format", "ppm", "--outdir"],
            "reproject --rubix": [*rep, "--rubix", "--format", "pcx", "--outdir"],
            "reproject --shard": [*rep, "--shard", "--format", "npz", "--outdir"],
            "reproject --aa 2": [*rep, "--aa", "2", "--format", "png", "--outdir"],
            "reproject --follow-poses": [*rep, "--follow-poses", "--format", "npz", "--outdir"],
            "reproject --format gif": [*rep, "--cmd", "f_lens fisheye1", "--format", "gif",
                                       "--outdir"],
            "sweep": ["sweep", *size, "--steps", "4", "--start", "120", "--stop", "300",
                      "--out"],
            "parity": ["parity", "--lens", "panini", "--width", "48", "--height", "36"],
            "bench --quick": ["bench", "--quick"],
        }
        t0 = time.perf_counter()
        procs = {}
        for name, args in cmds.items():
            out = None
            if args[-1] in ("--out", "--outdir"):
                out = tmp / "card" / name.replace(" ", "_").replace("-", "")
                if args[-1] == "--out":
                    out.parent.mkdir(exist_ok=True)
                    out = out.with_suffix(".npz" if name == "demo-synth" else ".gif")
                args = [*args, str(out)]
            procs[name] = spawn(args, out)
        timed_out = tmp / "card" / "reproject1080"
        procs["reproject 1080p"] = spawn(
            ["reproject", "--demo", str(demo1080), "--width", str(W), "--height", str(H),
             "--batch", str(CLI_1080_FRAMES), "--format", "pcx", "--outdir", str(timed_out)],
            timed_out)
        cpu_runs = {}
        for name, args in cmds.items():  # meanwhile, the same commands on the CPU
            if name == "bench --quick":
                continue
            if args[-1] in ("--out", "--outdir"):
                out = procs[name][1]
                cpu_out = tmp / "cpu" / out.relative_to(tmp / "card")
                cpu_out.parent.mkdir(parents=True, exist_ok=True)
                args = [*args, str(cpu_out)]
            cpu_runs[name] = on_cpu(args)
        results = {}
        for name, (proc, out) in procs.items():
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            require(proc.returncode == 0 or (name == "parity" and proc.returncode in (0, 1)),
                    f"cli {name} exited {proc.returncode}: {stderr[-3000:]}")
            results[name] = (proc.returncode, stdout)
        cli_s = time.perf_counter() - t0
        same, near = [], []
        for name, (rc, stdout) in results.items():
            if name in ("bench --quick", "reproject 1080p"):
                continue
            crc, cout = cpu_runs[name]
            require(rc == crc, f"cli {name}: exit {rc} on the card, {crc} on the CPU")
            if name == "parity":
                require(stdout == cout, f"cli parity: {stdout!r} on the card, {cout!r} on the CPU")
                same.append(name)
                continue
            out = procs[name][1]
            files = sorted(out.iterdir()) if out.is_dir() else [out]
            for f in files:
                other = tmp / "cpu" / f.relative_to(tmp / "card")
                if f.read_bytes() == other.read_bytes():
                    continue
                if f.suffix == ".npz":
                    with np.load(f) as a, np.load(other) as b_:
                        if all(np.array_equal(a[k], b_[k]) for k in a.files):
                            continue
                        share = float((a["screen"] != b_["screen"]).mean())
                else:
                    a, b_ = decode_gif(f.read_bytes())[0], decode_gif(other.read_bytes())[0]
                    share = max(float((a[..., i] != b_[..., i]).mean())
                                for i in range(a.shape[-1]))
                # the float32 lens stage (render_posed's ray table, the fused
                # sweep's): the card's transcendentals and the CPU's differ in
                # their last bits, which flips boundary texels
                require(name in FLOAT_STAGE and share <= FLOAT_STAGE[name],
                        f"cli {name}: {f.name} on the card differs from --device cpu")
                near.append(f"{name} ({share:.4f} of the pixels, within "
                            f"{FLOAT_STAGE[name]})")
                break
            else:
                same.append(f"{name} ({len(files)} files)")
        bench_line = json.loads(results["bench --quick"][1].splitlines()[-1])
        require(bench_line.get("equal") is True, f"cli bench --quick: {bench_line}")
        report = [ln for ln in results["reproject 1080p"][1].splitlines() if "fps" in ln]
        phase(14, f"the CLI in {len(procs)} processes at once ({cli_s:.1f} s wall): on the "
              f"card, byte-equal to --device cpu: {', '.join(same)}; not byte-equal, the float32 "
              f"lens stage: {', '.join(near) or 'none'}; bench --quick "
              f"{bench_line['fps']:.1f} frames/s at B=16 (1080p, the card); reproject of "
              f"{CLI_1080_FRAMES} {W}x{H} frames to PCX on the card: {report}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------ h: the viewer
    def free_port():
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            return s_.getsockname()[1]

    # `serve` in a process of its own, as a user starts it: its start to
    # device_ready on /state (the kernel library is built; the process's
    # start, the CUDA context, the native library's load, the float32 build
    # and the first K1 launch are in it)
    port = free_port()
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-m", "blinky_tpu_torch.cli", "serve", "--width", str(VIEW_W),
         "--height", str(VIEW_H), "--platesize", str(VIEW_S), "--port", str(port),
         "--device", dev.type], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        state, bound_s = None, None
        while time.perf_counter() - t0 < CLI_TIMEOUT_S and server.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/state", timeout=5) as r:
                    state = json.loads(r.read())
                bound_s = bound_s or time.perf_counter() - t0
                if state["device_ready"] or state["device_error"]:
                    break
            except OSError:
                pass
            time.sleep(0.05)
        serve_s = time.perf_counter() - t0
        require(state is not None and state["device_ready"] and state["device_error"] == "",
                f"cli serve's /state: {state}")
    finally:
        server.terminate()
        _, err = server.communicate(timeout=30)
    phase(14, f"cli serve ({VIEW_W}x{VIEW_H}) in a process of its own: bound and answering "
          f"/state {bound_s:.3f} s after its start, device_ready {serve_s:.3f} s after it, "
          "device_error empty")
    port = free_port()
    vs = Session(VIEW_W, VIEW_H, platesize=VIEW_S, device=dev)
    vs.cmd("f_shortcutkeys")
    vframes = synthetic_cubemap(VIEW_S)[None]
    t0 = time.perf_counter()
    v = Viewer(vs, vframes, port=port, device_warm=False)
    v.start()
    try:
        v.start_background_warm()
        require(v.device_ready.wait(120), "the viewer's warm did not finish in 120 s")
        ready_s = time.perf_counter() - t0

        def fetch(path, status=False):
            sep = "&" if "?" in path else "?"
            with urllib.request.urlopen(f"{v.address}{path}{sep}t={v.token}", timeout=60) as r:
                body = r.read()
                return (body, r.headers.get("X-Status", "")) if status else body

        state = json.loads(fetch("/state"))
        require(state["device_ready"] is True and state["device_error"] == "",
                f"the viewer's /state: {state}")
        # the viewer time-slices the exact build (1/60 s a frame) behind the
        # float32 preview: poll until the exact table has landed
        polls, hud = 0, "[exact build"
        while "[exact build" in hud and polls < 2000:
            png, hud = fetch("/frame.png?i=0", status=True)
            polls += 1
        cpu = Session(VIEW_W, VIEW_H, platesize=VIEW_S, device="cpu")
        want = encode_png(cpu.palette[host_array(cpu.render(vframes[0]))])
        require(png == want, "the viewer's /frame.png differs from the CPU session's screen")
        fetch("/cmd?c=setviewangles%2010%2030%200")
        dragged = fetch("/frame.png?i=0")
        fetch("/key?k=3")
        gif = fetch("/record.gif?n=1")
        require(len(dragged) > 0 and dragged != png and gif[:6] == b"GIF89a",
                "the viewer's drag-look or record.gif")
        phase(14, f"viewer ({VIEW_W}x{VIEW_H}): start to device_ready {ready_s:.3f} s (the "
              "kernel library already built by phase 1: the warm paid the native library's "
              "load, the float32 build, the first K1 launch); /frame.png, once the sliced "
              f"exact build landed ({polls} polls), byte-equal to the CPU session's screen; "
              "a drag-look, the key 3 (f_lens "
              f"{vs.lens_name}) and /record.gif answered; device_error empty")
    finally:
        v.stop()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    phase(14, f"launches in the phase's run (this process): "
          f"{ {k: n for k, n in launches.items() if n} }; phase 14 took "
          f"{time.perf_counter() - phase_t0:.1f} s")
    for name in ("remap_gather", "remap_lut", "posed_layout", "static_ray_posed",
                 "lensmap_resolve", "equirect_gather"):
        require(launches[name] >= 1, f"phase 14 did not launch {name}")
    return launches


# phase 15: globes that no shipped layout has (bench/fuzz_globes.py), on the
# main paths at full width.  Random globes of these plate counts, drawn from
# RG_SEED + the count, and the tie layout (two plates on one forward).
RG_PLATES = (1, 2, 4, 6)
RG_SEED = 1500
RG_POSES = 16          # render_posed at k = 1 on the 1- and 6-plate globes
RG_POSED = ("rand1", "rand6")
RG_SWEEP = "rand2"     # zoom_sweep_remap of an RG_SWEEP_STEPS ramp
RG_SWEEP_STEPS = 8
# the timed kernels, each named as its wrapper and inside its kernel record
RG_RECORDS = ("remap_gather", "remap_lut", "lensmap_resolve", "static_ray_posed",
              "sweep_remap")


def random_globes_phase(dev, main_rows):
    """Phase 15: four seeded random globes (1, 2, 4 and 6 plates) and the tie
    layout through the main paths at 1920x1080, S = 1080: each globe's exact
    host lensmap under a random rubix grid renders a random [6, S, S, 64] u8
    batch plain (K1), with ``f_rubix`` (K2) and with ``decode_rgb`` (K2),
    each screen bit-equal to the kernel's plain version and, for frames 0
    and 63, to ``host_remap``; ``build_lensmap(backend="torch")`` (the lens
    stage and K8 in max-dot mode), K8 bit-equal to its plain version on the
    same rays and the build within ``F32_SHARE`` of the exact one;
    ``render_posed`` of RG_POSES poses at k = 1 on the 1- and 6-plate globes
    (K7, K6) bit-equal to K6's plain version; ``zoom_sweep_remap`` of an
    RG_SWEEP_STEPS ramp on the 2-plate globe (K9) bit-equal to its plain
    version step by step.  Then each kernel's time on each globe by its
    kernel record, beside *main_rows* (kernel name -> the main path's ms).
    Returns the launches of the paths' run."""
    import shutil
    import tempfile

    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.bench import builder as bb
    from blinky_tpu_torch.bench.fuzz_globes import (ODD_PLATES, random_plates,
                                                    random_rubix_grid, write_globe)
    from blinky_tpu_torch.bench.posed import posed_poses
    from blinky_tpu_torch.kernels import posed, remap, static_ray
    from blinky_tpu_torch.lensmap import build_lensmap
    from blinky_tpu_torch.lensmap import builder

    phase_t0 = time.perf_counter()
    S, H, W = 1080, 1080, 1920
    npix = H * W
    layouts = {}
    for n in RG_PLATES:
        rng = np.random.default_rng(RG_SEED + n)
        layouts[f"rand{n}"] = (random_plates(rng, n), random_rubix_grid(rng))
    rng = np.random.default_rng(RG_SEED)
    layouts["tie"] = (ODD_PLATES["tie"], random_rubix_grid(rng))
    gen = torch.Generator(dev).manual_seed(RG_SEED)
    frames_rg = torch.randint(0, 256, (6, S, S, B_MAIN), dtype=torch.uint8, device=dev,
                              generator=gen)
    bg = rng.integers(0, 256, (H, W), dtype=np.uint8)
    poses = posed_poses(RG_POSES)
    bases_np = posed.bases_from_pose_track(poses)
    fovs = bb.sweep_fovs(steps=RG_SWEEP_STEPS)
    tmp = Path(tempfile.mkdtemp(prefix="blinky_globes_"))
    for name, (plates, _) in layouts.items():
        write_globe(tmp, name, plates)

    # ------------------------------------------------ the paths, counted
    path_kernels = [remap.remap_gather, remap.remap_lut, builder.lensmap_resolve,
                    static_ray.static_ray_posed, posed.posed_layout, posed.sweep_remap]
    for fn in path_kernels:
        fn.launches = 0
    sess = Session(W, H, device=dev, globe_dirs=[tmp])
    sess.set_background(bg)
    run = {}
    for name, (plates, grid) in layouts.items():
        r = run[name] = {"grid": grid}
        t0 = time.perf_counter()
        sess.cmd(f"f_globe {name}")
        sess.cmd("f_rubixgrid {} {!r} {!r}".format(*grid))
        require(sess.globe_valid and sess.globe.numplates == len(plates),
                f"f_globe {name} did not load the written globe")
        r["lm"] = sess.lensmap
        r["exact_s"] = time.perf_counter() - t0
        r["globe"], r["lens"] = sess.globe, sess.lens
        r["out"] = sess.render(frames_rg)
        sess.cmd("f_rubix")
        r["rubix"] = sess.render(frames_rg)
        sess.cmd("f_rubix")
        r["rgb"] = sess.render(frames_rg, decode_rgb=True)
        r["kernel"] = sess._kernel
        r["f32"] = build_lensmap(sess.lens, sess.globe, r["lm"].scale, W, H, S, *grid,
                                 backend="torch", device=dev)
        if name in RG_POSED:
            r["posed"] = sess.render_posed(frames_rg[..., :RG_POSES], poses, render_scale=1)
            r["posed_kernel"] = sess._posed_cache[1]
        if name == RG_SWEEP:
            r["scales"] = bb.sweep_scales(sess.lens, W, H, fovs)
            r["sweep"] = posed.zoom_sweep_remap(sess.lens, sess.globe, r["scales"],
                                                frames_rg[..., 0].contiguous(), W, H,
                                                device=dev)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in path_kernels}
    shutil.rmtree(tmp, ignore_errors=True)
    phase(15, f"launches in the random globes' run ({', '.join(layouts)}: exact host "
          f"lensmap, render plain, f_rubix and decode_rgb of the random [6, {S}, {S}, "
          f"{B_MAIN}] batch, build_lensmap(backend='torch'), render_posed of {RG_POSES} "
          f"poses on {' and '.join(RG_POSED)}, zoom_sweep_remap of {RG_SWEEP_STEPS} steps on "
          f"{RG_SWEEP}): {launches}")
    for name, n in launches.items():
        require(n >= 1, f"{name} was not launched by the random globes' paths")

    # ------------------------------------------------ checks
    src = frames_rg.reshape(-1, B_MAIN)
    ident = torch.from_numpy(builder.basis_f32(builder.IDENTITY_BASIS)).to(dev)
    for name, r in run.items():
        k, lm, g, grid = r["kernel"], r["lm"], r["globe"], r["grid"]
        valid = float(lm.valid.mean())
        require(lm.valid.any(), f"{name}: no pixel of the screen shows a plate")
        plain = {
            "out": remap.remap_gather_plain(src, k.flat_idx, k.valid, k.background,
                                            fill=True),
            "rubix": remap.remap_lut_plain(src, k.flat_idx, k.valid, k.tint, k.background,
                                           k.tint_lut),
            "rgb": remap.remap_lut_plain(src, k.flat_idx, k.valid, k.tint, k.background,
                                         None, k.rgb_lut)}
        for kind, ref in plain.items():
            got = r[kind]
            e = int((got.int() - ref.reshape(got.shape).int()).abs().max())
            require(torch.equal(got, ref.reshape(got.shape)),
                    f"{name}: render {kind} differs from the plain version (max {e})")
        del plain
        for b in (0, B_MAIN - 1):
            f = frames_rg[..., b].cpu().numpy()
            for kind, kw in (("out", {}), ("rubix", dict(rubix=True)),
                             ("rgb", dict(decode_rgb=True))):
                got = r[kind][..., b, :] if kind == "rgb" else r[kind][..., b]
                require(np.array_equal(got.cpu().numpy(), remap.host_remap(
                    lm, f, sess.palette, bg, **kw)), f"{name}: render {kind} frame {b} "
                    "differs from host_remap")
        # K8 on the lens stage's own rays, against its plain version
        rays = builder.lens_rays_torch(r["lens"], lm.scale, W, H, dev)
        got = builder.lensmap_resolve(g, *rays, S, *grid, builder.IDENTITY_BASIS)
        want = builder.rays_to_lensmap_torch(g, *rays, S, *grid, view_basis=ident)
        f32 = r["f32"]
        for f in ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used"):
            e = int((got[f].long() - want[f].long()).abs().max())
            require(got[f].dtype == want[f].dtype and torch.equal(got[f], want[f]),
                    f"{name}: lensmap_resolve {f} differs from rays_to_lensmap_torch (max {e})")
            require(torch.equal(getattr(f32, f), got[f]),
                    f"{name}: build_lensmap(backend='torch') {f} differs from K8 on its rays")
        r["rays"] = rays
        f32 = f32.to_numpy()
        share = float((f32.flat_idx != lm.flat_idx).mean())
        same = f32.valid & lm.valid & (f32.plate == lm.plate)
        off = max(int(np.abs(getattr(f32, f) - getattr(lm, f))[same].max(initial=0))
                  for f in ("px", "py"))
        r["share"] = share
        g_ = r["globe"]
        phase(15, f"{name}: {g_.numplates} plates, fovs "
              f"{[round(float(v), 2) for v in np.degrees(g_.fov_rad)]} deg, f_rubixgrid "
              "{} {:.4f} {:.4f}; ".format(*grid) + f"exact host lensmap in "
              f"{r['exact_s']:.3f} s, {valid:.4f} of the pixels valid, plates used "
              f"{lm.plates_used[:g_.numplates].astype(int).tolist()}; render, f_rubix and "
              f"decode_rgb bit-equal the plain versions on the card and host_remap for "
              f"frames 0 and {B_MAIN - 1}; K8 bit-equal its plain version; the float32 "
              f"build's flat_idx differs from the exact build's on {share:.6f} of the pixels "
              f"({int((f32.flat_idx != lm.flat_idx).sum())} of {npix}), px and py by at most "
              f"{off} texel where both are valid on one plate")
        require(share <= F32_SHARE and off <= 1,
                f"{name}: the float32 build is not within the boundary tolerance of the "
                f"exact one ({share}, {off})")
        if name in RG_POSED:
            kern = r["posed_kernel"]
            for lo in range(0, RG_POSES, CHUNK):
                src_c, b32, exp = posed.prep_posed_inputs(
                    frames_rg[..., lo:lo + CHUNK], bases_np[lo:lo + CHUNK], S,
                    kern.background, dev)
                ref = static_ray.static_ray_posed_plain(
                    src_c, kern.ray_table, b32, kern.globe, S, kern.numcells, kern.cell_size,
                    kern.pad_size, exp, kern.background, 1)
                e = int((r["posed"][lo:lo + CHUNK].long() - ref.long()).abs().max())
                require(torch.equal(r["posed"][lo:lo + CHUNK], ref),
                        f"{name}: render_posed poses {lo}.. differ from "
                        f"static_ray_posed_plain (max {e})")
            phase(15, f"{name}: render_posed of {RG_POSES} poses at k = 1 bit-equal "
                  "static_ray_posed_plain on the card")
        if name == RG_SWEEP:
            step_rays = builder.lens_rays_torch(
                r["lens"], torch.tensor(r["scales"], dtype=torch.float64), W, H, dev)
            src_d = frames_rg[..., 0].contiguous().reshape(-1)
            zero_bg = torch.zeros((H, W), dtype=torch.uint8, device=dev)
            args = (src_d, *step_rays, g, S, 10.0, 4.0, 1.0, False, zero_bg)
            require(torch.equal(posed.sweep_remap(*args), r["sweep"]),
                    f"{name}: zoom_sweep_remap differs from sweep_remap on the same rays")
            for n in range(RG_SWEEP_STEPS):
                ref = posed.sweep_remap_plain(src_d, *(t[n:n + 1] for t in step_rays), g, S,
                                              10.0, 4.0, 1.0, False, zero_bg)
                e = int((r["sweep"][n:n + 1].long() - ref.long()).abs().max())
                require(torch.equal(r["sweep"][n:n + 1], ref),
                        f"{name}: sweep step {n} differs from its plain version (max {e})")
            r["sweep_args"] = args
            phase(15, f"{name}: zoom_sweep_remap of {RG_SWEEP_STEPS} steps (f_fov "
                  f"{fovs[0]}..{fovs[-1]}) bit-equal sweep_remap_plain step by step")

    # ------------------------------------------------ times, by kernel record
    for name, r in run.items():
        k, g, grid = r["kernel"], r["globe"], r["grid"]
        calls = [
            lambda k=k: remap.remap_gather(src, k.flat_idx, k.valid, k.background, fill=True),
            lambda k=k: remap.remap_lut(src, k.flat_idx, k.valid, k.tint, k.background,
                                        k.tint_lut),
            lambda g=g, grid=grid, rays=r["rays"]: builder.lensmap_resolve(
                g, *rays, S, *grid, builder.IDENTITY_BASIS)]
        if name in RG_POSED:
            kern = r["posed_kernel"]
            src_c, b32, exp = posed.prep_posed_inputs(frames_rg[..., :RG_POSES], bases_np, S,
                                                      kern.background, dev)
            calls.append(lambda kern=kern, src_c=src_c, b32=b32, exp=exp:
                         static_ray.static_ray_posed(
                             src_c, kern.ray_table, b32, kern.globe, S, kern.numcells,
                             kern.cell_size, kern.pad_size, exp, kern.background, 1))
        if name == RG_SWEEP:
            calls.append(lambda args=r["sweep_args"]: posed.sweep_remap(*args))
        _, dev_ms, _ = profiled(lambda calls=calls: [c() for c in calls], ITERS, sync=False)
        r["ms"] = {kname: sum(t for n_, t in dev_ms.items() if kname in n_)
                   for kname in RG_RECORDS if any(kname in n_ for n_ in dev_ms)}
        rows = source_rows(k.flat_idx, k.valid, src.shape[0], True)
        n_valid = int(k.valid.sum())
        k1_bytes = npix * 6 + (rows + npix) * B_MAIN
        r["k1_bound"] = k1_bytes / HBM_BYTES_PER_S * 1e3
        phase(15, f"{name} by kernel record (ms a call; the main path's row beside it): "
              + ", ".join(f"{kname} {t:.4f} ({main_rows[kname]:.4f})"
                          for kname, t in r["ms"].items())
              + f"; K1 reads {rows} distinct source rows for {n_valid} valid pixels, "
              f"{k1_bytes} bytes, bound {r['k1_bound']:.4f} ms, "
              f"{100 * r['k1_bound'] / r['ms']['remap_gather']:.1f} % of it")
        for kname in ("remap_gather", "remap_lut", "lensmap_resolve"):
            require(r["ms"].get(kname, 0) > 0, f"{name}: no kernel record of {kname}")
    del frames_rg, src, run
    torch.cuda.empty_cache()
    phase(15, f"phase 15 took {time.perf_counter() - phase_t0:.3f} s")
    return launches


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sweep"]:
        if not torch.cuda.is_available():
            print("chip_smoke --sweep: no CUDA device", file=sys.stderr)
            sys.exit(1)
        if sys.argv[2:] == ["k10"]:
            sys.exit(sweep_k10())
        sys.exit(sweep() or sweep_k10())
    sys.exit(main())
