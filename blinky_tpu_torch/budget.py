"""The memory plan of a Session call: how many poses, zoom steps or frames
one call may take at once.

A call shares the card with whatever else the process holds, so it plans
on the memory free when the call is planned (``torch.cuda.mem_get_info``,
or the host's available memory for a CPU device) times
:data:`BUDGET_FRACTION`, and does not round the batch (``quantum=1``, the
default): the posed kernels take poses eight to a block, and a partial
group costs nothing.  Each pipeline states its per-lane (per-pose,
per-step) byte cost, and :func:`feasible_batch` returns the largest batch
that fits.  Its callers:

* ``Session.render_posed``'s chunk cap (:func:`posed_bytes_per_lane`);
* the zoom sweep, ``kernels.posed.zoom_sweep_remap``
  (:func:`sweep_bytes_per_lane`);
* a script globe's resolver, ``kernels.static_ray.script_pose_plates``
  (:func:`script_bytes_per_lane`);
* ``cli reproject --batch 0`` (:func:`planes_bytes_per_lane`,
  :func:`screen_bytes_per_lane`, :func:`posed_bytes_per_lane`, and
  :func:`aa_bytes_per_lane` under ``--aa``).

The arithmetic of :func:`feasible_batch` and of the plate-plane and
screen models is :mod:`blinky_tpu.bench.autobatch`'s.  A bench process,
which owns its card, plans with the same function on another budget
(:mod:`blinky_tpu_torch.bench.autobatch`).
"""

from __future__ import annotations

import os

import torch

from blinky_tpu_torch.palette import MAX_PLATES

# Of the free memory, what a Session call may plan to fill.  The caching
# allocator rounds each block up (to 2 MB for large ones) and may not find
# one contiguous free range for a tensor of hundreds of MB after other
# frees; a tenth held back covers both at the posed path's few large
# tensors a call.
BUDGET_FRACTION = 0.9


def device_memory_bytes(device) -> int:
    """Free memory on *device* now: the card's, from
    ``torch.cuda.mem_get_info``, or the host's available physical memory
    for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def free_budget_bytes(device) -> int:
    """What a Session call may plan to fill: the free memory of *device*
    times :data:`BUDGET_FRACTION`."""
    return int(device_memory_bytes(device) * BUDGET_FRACTION)


def feasible_batch(src_bytes_per_lane, out_bytes_per_lane, *, device="cuda",
                   budget=None, quantum=1, cap=None, n_devices=1) -> int:
    """Largest batch (a multiple of *quantum*) whose per-lane live set
    (source + output) fits the budget, by default :func:`free_budget_bytes`
    of *device*; *cap* bounds it (e.g. the number of frames there are).

    The arithmetic is ``blinky_tpu.bench.autobatch.feasible_batch``'s: when
    not even one *quantum* of lanes fits, the count that fits is returned
    unrounded (never bumped up to a full quantum); ``budget`` is per device,
    and with ``n_devices > 1`` the batch is that many times the per-device
    batch, a *cap* rounded down to a multiple of the device count.  Always
    >= 1, so callers can chunk by it."""
    budget = free_budget_bytes(device) if budget is None else int(budget)
    per_lane = float(src_bytes_per_lane) + float(out_bytes_per_lane)
    b = int(budget // max(per_lane, 1.0))
    bq = b // quantum * quantum
    b = bq if bq >= quantum else b
    n_dev = max(int(n_devices), 1)
    b = max(b, 1) * n_dev
    if cap is not None:
        c = int(cap)
        if n_dev > 1 and c >= n_dev:
            # a split batch divides evenly over the devices
            c = c // n_dev * n_dev
        b = min(b, c)
    return b


def screen_bytes_per_lane(width, height, rgba=False) -> int:
    """The materialized [H, W] screen, per lane."""
    return width * height * (4 if rgba else 1)


def planes_bytes_per_lane(planesize, nplanes, rgba=False, expanded=False,
                          padded=True) -> int:
    """[NP, S, S, B] plate-plane source on the device: one lane's bytes.
    With *padded* (the default), the plain device layout: a P < MAX_PLATES
    source is zero-padded to MAX_PLATES planes, the expanded layout is
    always 2 * MAX_PLATES.  ``padded=False`` counts a plane-compacted slab
    (``kernels.remap.compact_planes``), which holds only its *nplanes*
    (twice that expanded)."""
    if expanded:
        np_ = 2 * MAX_PLATES if padded else 2 * nplanes
    else:
        np_ = max(nplanes, MAX_PLATES) if padded else nplanes
    return np_ * planesize * planesize * (4 if rgba else 1)


def posed_bytes_per_lane(planesize, nplanes, width, height, rgba=False,
                         expanded=False, script=False) -> int:
    """What a static-ray posed call keeps per pose: the caller's frames on
    the device, their pose-major copy (``prep_posed_inputs``) and the
    full-resolution screen, and with a *script* globe the pose's int8
    plates (at most a byte a screen pixel).  The JAX pipeline also held a
    [H/k, W/k] int32 index table and its bool mask per pose; the fused
    kernel (K6) writes none, so the render scale does not enter the count.
    A script's evaluation is chunked on its own
    (:func:`script_bytes_per_lane`)."""
    planes = planes_bytes_per_lane(planesize, nplanes, rgba, expanded)
    return (2 * planes + screen_bytes_per_lane(width, height, rgba)
            + (width * height if script else 0))


def aa_bytes_per_lane(planesize, nplanes, width, height, factor, rgba=False) -> int:
    """What ``Session.render_aa`` keeps per lane: the source planes, their
    packed-RGBA decode (none when the source is *rgba* already), the
    ``factor`` x ``factor`` supersampled screen and the screen it is
    box-filtered to, both packed RGBA."""
    texels = nplanes * planesize * planesize
    source = texels * (4 if rgba else 1)
    decoded = 0 if rgba else 4 * texels
    k = int(factor)
    return (source + decoded + screen_bytes_per_lane(k * width, k * height, rgba=True)
            + screen_bytes_per_lane(width, height, rgba=True))


# float32 planes the lens stage may hold live at once for one zoom step: the
# grid, the rays and the temporaries of the widest ported lens.  Read on an
# NVIDIA H100 80GB HBM3 at 1920x1080 by chip_smoke.py's phase 7
# (bench/builder.py::lens_stage_peak_planes, torch.cuda.max_memory_allocated
# around the lens stage): winkeltripel 32.57 planes a pixel, panini 7.00.
# 40 leaves a fifth above the widest for the allocator's rounding; phase 7
# fails if a reading passes it.
SWEEP_LENS_PLANES = 40


def sweep_bytes_per_lane(width, height, rgba=False, script=False) -> int:
    """What the fused zoom sweep keeps per zoom step: the lens stage's live
    float32 planes (:data:`SWEEP_LENS_PLANES`), the step's 13-byte-a-pixel
    ray table and its screen; with a *script* globe also the step's unit
    rays and int8 plates (its resolver's live planes fit the lens stage's,
    which are freed before it runs)."""
    return width * height * (4 * SWEEP_LENS_PLANES + 13 + (13 if script else 0)) + \
        screen_bytes_per_lane(width, height, rgba)


def script_bytes_per_lane(npix) -> int:
    """What evaluating a script globe's resolver keeps per pose or zoom step
    of *npix* rays: the 12-byte unit rays (:func:`rotate_rays`' output),
    the script's live float32 planes, bounded like the lens stage's by
    :data:`SWEEP_LENS_PLANES`, and the plates as int32 and int8."""
    return npix * (12 + 4 * SWEEP_LENS_PLANES + 5)
