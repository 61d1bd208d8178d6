"""The bench suite's eight configs, on the card.

The port of :mod:`blinky_tpu.bench.configs`: each config returns one
JSON-able dict with correctness evidence and timings, with the JAX config's
keys, batches, lenses, globes, zooms and sizes.  ``python -m
blinky_tpu_torch.bench --all`` runs the suite and ``--check`` gates it
against the baseline (:mod:`blinky_tpu_torch.bench.check`).

Configs:
  0. panini+cube 640x480: single-frame remap of f_saveglobe faces.
  1. stereographic/fisheye1 f_fov zoom sweep (the device rebuild path).
  2. cartographic 360 lenses (quincuncial, mercator, winkeltripel).
  3. low-poly globes (trism, fast, tetra) with f_cover/f_contain autofit.
  4. batched 1080p reprojection: plain, rubix overlay, RGBA, plate-,
     row- and texel-compacted sources.
  5. pose-tracked 1080p playback, chunked and per frame.
  6. 4K batched reprojection.
  7. equirect 360-video end to end.

The measurements that fill the card (config 4's six row-cropped and
texel-compacted runs, config 6's two 4K runs and config 7's seven full-mode
equirect runs) each run in a process of their own, ``python -m
blinky_tpu_torch.bench <flag>`` on the card, so that one running out of
memory loses only its own number: it is recorded as ``None`` beside a
``*_error`` key naming the exception, which the gate fails.  Every other
config runs on *device*.

Every measurement holds the kernels it times to their plain versions on its
own inputs before it times them (K1, K2, K5-K8 and K10:
``throughput.checked``): a kernel that differs raises here, and in a
measurement's own process fails that process, so it is recorded as
``*_error``, never as a number.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

# the repository root: the measurement processes run there, so that a
# checkout (or a git archive of one) finds the package without installing it
ROOT = Path(__file__).resolve().parents[2]
N_CONFIGS = 8
# decimals kept of every ms figure: the JAX suite kept one or two, which on
# the card rounds a 0.6 ms rebuild or a 0.02 ms posed frame to a step of its
# own size, and the gate then compares the rounding
MS_DIGITS = 4


def _ms(t0):
    return round((time.perf_counter() - t0) * 1000, MS_DIGITS)


def _sync(device):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _release_card_memory() -> None:
    """Hand the memory this process's allocator caches back to the card, so
    that a measurement process started next may fill it: what the earlier
    configs freed stays reserved by the caching allocator until then."""
    if torch.cuda.is_initialized():
        gc.collect()
        torch.cuda.empty_cache()


def _bench_subprocess(flag: str, quick: bool = False) -> dict:
    """Run one measurement in its own process on the card, and parse the
    last JSON line it prints.  A failure raises; the child's last lines of
    standard error go to this process's."""
    _release_card_memory()
    args = [sys.executable, "-m", "blinky_tpu_torch.bench", flag] + (["--quick"] if quick else [])
    try:
        r = subprocess.run(args, capture_output=True, text=True, timeout=1200, check=True,
                           cwd=ROOT)
    except subprocess.CalledProcessError as e:
        tail = (e.stderr or "").strip().splitlines()[-5:]
        print(f"{flag} failed (exit {e.returncode}):", *tail, sep="\n  ", file=sys.stderr)
        raise
    return json.loads(r.stdout.strip().splitlines()[-1])


def _isolated(out: dict, key: str, flag: str, quick: bool = False) -> dict:
    """Measure ``out[key]`` in its own process (:func:`_bench_subprocess`),
    or record the failure: ``None`` and ``*_error`` with the exception's
    name.  Returns the parsed line, or an empty dict on a failure."""
    try:
        parsed = _bench_subprocess(flag, quick)
    except (subprocess.SubprocessError, OSError, ValueError, IndexError, KeyError) as e:
        out[key] = None
        out[key.replace("_fps", "_error")] = type(e).__name__
        return {}
    out[key] = round(parsed["fps"], 1)
    return parsed


def config0_saveglobe_roundtrip(*, device="cuda"):
    """panini+cube 640x480: export plates as PCX, reload, remap one frame;
    verify the remap against direct NumPy indexing of the lensmap."""
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.io.cubemap import load_globe_pcx, save_globe_pcx, synthetic_cubemap

    sess = Session(640, 480, device=device)
    frames = synthetic_cubemap(sess.platesize)
    with tempfile.TemporaryDirectory() as d:
        prefix = str(Path(d) / "glb")
        t0 = time.perf_counter()
        save_globe_pcx(prefix, frames, sess.globe, sess.palette, with_margins=True)
        export_ms = _ms(t0)
        loaded, _ = load_globe_pcx(prefix, sess.globe.numplates)
    n = sess.globe.numplates
    if not np.array_equal(loaded[:n], frames[:n]):
        raise AssertionError("the PCX round trip changed the plates")
    sess.render(loaded).cpu()  # warm-up: the operands' upload
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = sess.render(loaded).cpu().numpy()
        samples.append(_ms(t0))
    remap_ms = sorted(samples)[1]
    lm = sess.lensmap.to_numpy()
    exp = np.where(lm.valid, loaded[np.clip(lm.plate, 0, 5), lm.py, lm.px], 0)
    ok = bool(np.array_equal(out, exp.astype(np.uint8)))
    return dict(config=0, name="panini+cube 640x480 saveglobe roundtrip",
                exact=ok, pcx_export_ms=export_ms, remap_ms=remap_ms)


def config1_zoom_sweep(*, device="cuda"):
    """f_fov sweep on stereographic + fisheye1: every rebuild after the
    first is a warm float32 device build (the lens stage and K8)."""
    from blinky_tpu_torch.bench.throughput import checked, run_build_bench

    out = {}
    for lens_name in ("stereographic", "fisheye1"):
        r = checked(run_build_bench(lens_name=lens_name, device=device), lens_name)
        out[lens_name] = dict(
            first_ms=round(r["first_ms"], MS_DIGITS),
            warm_ms=round(r["warm_ms"], MS_DIGITS),
            device_ms=None if r["device_ms"] is None else round(r["device_ms"], MS_DIGITS),
        )
    return dict(config=1, name="f_fov zoom sweep rebuild", **out)


def _timed_build(lens, g, scale, w, h, device, warm_reps=3):
    """First-call and warm-median timings of the float32 device build of one
    lens/globe config.  The first call is reported as the ungated
    ``first_build_ms``; the gated ``build_ms`` is the median of warm
    rebuilds.  Then K8 is held to its plain version."""
    from blinky_tpu_torch.bench.throughput import build_equal, checked

    def build():
        lm = build_lensmap(lens, g, scale, w, h, backend="torch", device=device)
        _sync(device)
        return lm

    t0 = time.perf_counter()
    lm = build()
    first_ms = _ms(t0)
    warm = []
    for _ in range(warm_reps):
        t0 = time.perf_counter()
        lm = build()
        warm.append(_ms(t0))
    checked(dict(equal=build_equal(lens, g, scale, w, h, min(w, h), device=device)),
            f"{lens.name}+{g.name} {w}x{h}")
    return lm.to_numpy(), first_ms, sorted(warm)[len(warm) // 2]


def config2_cartographic(*, device="cuda"):
    """360-degree cartographic lenses, full-sphere inverse path."""
    res = {}
    for lens_name in ("quincuncial", "mercator", "winkeltripel"):
        g = globes.get("cube")
        lens = lenses.get(lens_name, g)
        zoom = Zoom("cover") if lens_name == "mercator" else Zoom("contain")
        scale = calc_scale(zoom, lens, 1280, 720)
        lm, first_ms, warm_ms = _timed_build(lens, g, scale, 1280, 720, device)
        res[lens_name] = dict(
            build_ms=warm_ms,
            first_build_ms=first_ms,
            coverage=round(float(lm.valid.mean()), 4),
            plates_used=int(lm.plates_used.sum()),
        )
    return dict(config=2, name="cartographic 360 lenses", **res)


def config3_low_poly(*, device="cuda"):
    """trism (5 plates), fast (2 overlaid plates, custom resolver) and tetra
    with autofit zooms: the reference's quality<->speed tradeoff globes."""
    res = {}
    for globe_name, lens_name, zoom in (
        ("trism", "fisheye1", Zoom("contain")),
        ("fast", "panini", Zoom("fov", 140)),
        ("tetra", "cylinder", Zoom("cover")),
    ):
        g = globes.get(globe_name)
        lens = lenses.get(lens_name, g)
        scale = calc_scale(zoom, lens, 1280, 720)
        lm, first_ms, warm_ms = _timed_build(lens, g, scale, 1280, 720, device)
        res[globe_name] = dict(
            build_ms=warm_ms,
            first_build_ms=first_ms,
            numplates=g.numplates,
            plates_used=int(lm.plates_used.sum()),
        )
    return dict(config=3, name="low-poly globes autofit", **res)


# config 4's isolated measurements: key -> the flag of __main__ that runs it
ROWCROP_FLAGS = (("rubix_rowcrop_fps", "--config-rowcrop-rubix"),
                 ("rgba_rowcrop_fps", "--config-rowcrop-rgba"),
                 ("rubix_rgba_rowcrop_fps", "--config-rowcrop-both"),
                 ("rubix_texels_fps", "--config-rowcrop-txrubix"),
                 ("rgba_texels_fps", "--config-rowcrop-txrgba"),
                 ("rubix_rgba_texels_fps", "--config-rowcrop-txboth"))


def config4_batched_demo(quick=False, *, device="cuda"):
    """1080p batched reprojection: plain (K1), rubix overlay (expanded
    source) and packed RGBA; plate-compacted, post-gather-tinted,
    row-cropped and texel-compacted sources."""
    from blinky_tpu_torch.bench.throughput import (
        checked, run_gather_throughput, run_throughput,
    )

    b_plain, b_rubix, b_rgba = (128, 64, 32) if quick else (1024, 512, 256)
    iters = 3 if quick else 6
    kw = dict(iters=iters, device=device)

    def gather(**kw_):
        return checked(run_gather_throughput(**kw_, **kw))

    plain = checked(run_throughput(batch=b_plain, **kw))
    rubix = gather(batch=b_rubix, rubix=True, rgba=False)
    rgba = gather(batch=b_rgba, rubix=False, rgba=True)
    b_rubix_c, b_rgba_c, b_both_c = (96, 48, 32) if quick else (768, 384, 256)
    rubix_c = gather(batch=b_rubix_c, rubix=True, rgba=False, compact=True)
    rgba_c = gather(batch=b_rgba_c, rubix=False, rgba=True, compact=True)
    both_c = gather(batch=b_both_c, rubix=True, rgba=True, compact=True)
    both_post = gather(batch=48 if quick else 384, rubix=True, rgba=True, compact=True,
                       tint_post=True)
    rowcrop = {}
    for key, flag in ROWCROP_FLAGS:
        _isolated(rowcrop, key, flag, quick)
    return dict(
        config=4,
        name="batched 1080p demo reprojection",
        plain_fps=round(plain["fps"], 1),
        rubix_fps=round(rubix["fps"], 1),
        rgba_fps=round(rgba["fps"], 1),
        rubix_compact_fps=round(rubix_c["fps"], 1),
        rgba_compact_fps=round(rgba_c["fps"], 1),
        rubix_rgba_compact_fps=round(both_c["fps"], 1),
        rubix_rgba_postgather_fps=round(both_post["fps"], 1),
        **rowcrop,
        first_build_ms=round(plain["build_ms"], MS_DIGITS),
        rebuild_ms=round(plain["rebuild_ms"], MS_DIGITS),
    )


def config5_pose_playback(quick=False, *, device="cuda"):
    """Pose-tracked playback, both granularities: chunked (one lensmap a
    chunk, built on the device) and per-frame poses, through the static-ray
    kernel (the default ``render_posed`` path), ``PosedRemapKernel`` and a
    forward-only lens.  The chunk of 1024 runs in quick mode too: it fits an
    80 GB card many times over, and the JAX suite skipped it in quick mode
    only for the v5e's memory."""
    from blinky_tpu_torch.bench.throughput import (
        checked, run_forward_posed_throughput, run_per_frame_pose_throughput,
        run_pose_tracked_throughput, run_static_ray_pose_throughput,
    )

    chunked = checked(run_pose_tracked_throughput(batch=32 if quick else 256,
                                                  iters=3 if quick else 8, device=device))
    per_frame = checked(run_per_frame_pose_throughput(batch=8 if quick else 16,
                                                      reps=2 if quick else 3, device=device))
    static_ray = checked(run_static_ray_pose_throughput(batch=8 if quick else 16,
                                                        reps=2 if quick else 3,
                                                        device=device))
    fwd_kw = dict(batch=4, reps=2) if quick else dict(batch=16, reps=3)
    forward = checked(run_forward_posed_throughput(**fwd_kw, device=device))
    chunked_max = checked(run_pose_tracked_throughput(batch=1024, iters=3 if quick else 8,
                                                      device=device))
    return dict(
        config=5,
        name="pose-tracked 1080p playback",
        chunked_fps=round(chunked["fps"], 1),
        chunked_fps_1024=round(chunked_max["fps"], 1),
        per_frame_fps=round(static_ray["fps"], 1),
        per_frame_ms=round(static_ray["ms_per_frame"], MS_DIGITS),
        per_frame_fps_scale2=round(static_ray["fps_scale2"], 1),
        per_frame_ms_scale2=round(static_ray["ms_per_frame_scale2"], MS_DIGITS),
        builder_fused_fps=round(per_frame["fps"], 1),
        builder_fused_fps_scale2=round(per_frame["fps_scale2"], 1),
        forward_fps=round(forward["fps"], 1),
        forward_table_ms=round(forward["table_ms"], MS_DIGITS),
        forward_exact_fps=round(forward["exact_fps"], 3),
        forward_exact_ms=round(forward["exact_ms_per_frame"], MS_DIGITS),
    )


def config6_4k(quick=False, *, device="cuda"):
    """4K (3840x2160) batched reprojection on the plate-compacted source,
    plain and rubix, each in its own process at the derived batch (small
    explicit batches in quick mode)."""
    out = dict(config=6, name="4K batched reprojection")
    for key, flag in (("plain_fps", "--config4k-plain"), ("rubix_fps", "--config4k-rubix")):
        parsed = _isolated(out, key, flag, quick)
        if parsed:
            out[key.replace("_fps", "_config")] = parsed["config"]
    return out


# config 7's full-mode measurements: key -> flag
EQ_FLAGS = (("bilinear_fps", "--config-eq-plain"),
            ("bilinear_rubix_fps", "--config-eq-rubix"),
            ("nearest_fps", "--config-eq-nearest"),
            ("bilinear_texels_fps", "--config-eq-texels"),
            ("bilinear_rubix_texels_fps", "--config-eq-txrubix"),
            ("bilinear_fused_fps", "--config-eq-fused"),
            ("bilinear_rubix_fused_fps", "--config-eq-fxrubix"))


def config7_equirect(quick=False, *, device="cuda"):
    """360-video end to end: a pano batch made on the card through
    ``Session.render_equirect`` (4096x2048 -> S = 720 -> 1280x720),
    bilinear plain and rubix (the post-gather tint), nearest, the texel
    subset and the fused chain.  Full mode runs B = 128, each variant in its
    own process; quick mode B = 4 on *device*."""
    name = "equirect 360-video end-to-end (4096x2048 -> 720p)"
    if quick:
        from blinky_tpu_torch.bench.throughput import checked, run_equirect_throughput

        def run(**kw):
            return checked(run_equirect_throughput(batch=4, iters=2, device=device, **kw))

        plain = run(bilinear=True, rubix=False)
        rubix = run(bilinear=True, rubix=True)
        nearest = run(bilinear=False, rubix=False)
        fused = run(bilinear=True, rubix=False, fused=True)
        return dict(
            config=7, name=name,
            bilinear_fps=round(plain["fps"], 1),
            bilinear_rubix_fps=round(rubix["fps"], 1),
            nearest_fps=round(nearest["fps"], 1),
            bilinear_fused_fps=round(fused["fps"], 1),
            ms_per_batch=round(plain["ms_per_batch"], MS_DIGITS),
        )
    out = dict(config=7, name=name)
    for key, flag in EQ_FLAGS:
        parsed = _isolated(out, key, flag)
        if parsed and key == "bilinear_fps":
            out["ms_per_batch"] = round(parsed["ms_per_batch"], MS_DIGITS)
            out["bilinear_config"] = parsed["config"]
    return out


def run_all(quick=False, only=None, *, device="cuda"):
    """Run the config suite on *device*; ``only`` (an iterable of config
    indices) selects a subset, so that the gate can run in bounded
    segments."""
    fns = [
        lambda: config0_saveglobe_roundtrip(device=device),
        lambda: config1_zoom_sweep(device=device),
        lambda: config2_cartographic(device=device),
        lambda: config3_low_poly(device=device),
        lambda: config4_batched_demo(quick=quick, device=device),
        lambda: config5_pose_playback(quick=quick, device=device),
        lambda: config6_4k(quick=quick, device=device),
        lambda: config7_equirect(quick=quick, device=device),
    ]
    if only is None:
        sel = range(len(fns))
    else:
        sel = sorted(set(only))
        bad = [i for i in sel if not 0 <= i < len(fns)]
        if bad:
            raise ValueError(f"unknown config indices {bad}; valid: 0-{len(fns) - 1}")
    return [fns[i]() for i in sel]
