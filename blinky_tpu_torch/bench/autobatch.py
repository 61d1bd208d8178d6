"""Memory-aware batch sizing: how many lanes a call or a bench run may take.

The port of :mod:`blinky_tpu.bench.autobatch`.  Each pipeline states its
per-lane (per-pose, per-pano) byte cost, and :func:`feasible_batch` returns
the largest batch that fits a budget.  There are two budgets, for two kinds
of caller:

* :func:`free_budget_bytes` -- a ``Session`` call (``render_posed``, the zoom
  sweep, a script resolver, ``render_equirect``) shares the card with
  whatever else the process holds, so it plans on the memory free when the
  call is planned (``torch.cuda.mem_get_info``) times
  :data:`BUDGET_FRACTION`, and does not round the batch (``quantum=1``, the
  default): the posed kernels take poses eight to a block, and a partial
  group costs nothing.
* :func:`effective_budget_bytes` -- a bench process owns the card, so it
  plans on the card's whole memory (:func:`device_hbm_bytes`) times
  :data:`EFFECTIVE_FRACTION`, measured by the calibrate walk
  (:mod:`blinky_tpu_torch.bench.calibrate`), and rounds the batch down to
  :data:`QUANTUM` lanes, as the JAX suite does.  The bench's callers pass
  both themselves: ``feasible_batch(..., budget=effective_budget_bytes(dev),
  quantum=QUANTUM)``.

Live-set model: a bench measurement keeps the source and one gathered screen
(``run_gather_throughput`` frees each screen before the next launch), and
PyTorch allocates exactly the tensors the model counts.  What it does not
count is the CUDA context, the lensmap's operands and the allocator's
rounding, so :data:`EFFECTIVE_FRACTION` is below 1 (the JAX package's v5e
constant, 1.0286, sat above 1 because XLA kept some 3 % less live than the
model counted).
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

# Of the card's whole memory, what a bench process may plan to fill with
# source + screen lanes.  The calibrate walk on an NVIDIA H100 80GB HBM3 at
# 700 W (``python -m blinky_tpu_torch.bench --calibrate``, its result in
# bench_calibration.json beside this module) ran the texel-compacted 1080p
# layout at B = 22,272 and ran out of memory at 22,400 of 85,017,493,504
# bytes: implied fractions 0.9876-0.9933.  The derived batch must never run
# out of memory, and a bench run may share the card with the context of the
# process that started it, so the constant sits 1.8 % under the interval's
# floor (1.5 GB at the headline's lane size).  Re-run the walk on another
# card before changing it.
EFFECTIVE_FRACTION = 0.97
# The batch quantum of the bench's derived batches: the JAX suite's 128 lanes
# (a TPU tile), kept so that the two suites' batches compare; K1 moves rows
# of 16-byte vectors, which every multiple of 16 lanes fills.
QUANTUM = 128


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


def device_hbm_bytes(device="cuda") -> int:
    """The whole memory of *device*: ``BLINKY_HBM_BYTES`` when it is set, else
    the card's ``total_memory``.  Any other device raises ValueError: the
    bench plans to fill a card it owns, and a plan that filled the host's
    memory would fill it."""
    env = os.environ.get("BLINKY_HBM_BYTES")
    if env:
        return int(env)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_hbm_bytes: {device} is not a CUDA device; set "
                         "BLINKY_HBM_BYTES to plan for it")
    return int(torch.cuda.get_device_properties(device).total_memory)


def effective_budget_bytes(device="cuda") -> int:
    """What a bench process that owns *device* may plan to fill:
    :func:`device_hbm_bytes` times :data:`EFFECTIVE_FRACTION`."""
    return int(device_hbm_bytes(device) * EFFECTIVE_FRACTION)


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


def rows_bytes_per_lane(nrows, platesize, rgba=False) -> int:
    """Row-cropped stack ``[R_rows, S, B]`` (``kernels.remap.compact_rows``)."""
    return nrows * platesize * (4 if rgba else 1)


def texels_bytes_per_lane(ntexels, rgba=False) -> int:
    """Texel-compacted source ``[R, B]`` (``kernels.remap.compact_texels``);
    R counts only the texels the lensmap reads, rubix included."""
    return ntexels * (4 if rgba else 1)


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


def equirect_bytes_per_lane(pano_h, pano_w, platesize, width, height,
                            mode="compact", texels=None) -> int:
    """What one pano lane keeps on the device through
    ``Session.render_equirect``: the pano, the faces between the two stages
    (all ``MAX_PLATES`` plates for ``"faces"``, the ``[R]`` texels the
    lensmap reads for ``"compact"`` -- *texels*, or every texel when it is
    not known yet -- and none for ``"fused"``) and the screen, all packed
    RGBA."""
    full = MAX_PLATES * platesize * platesize
    faces = {"faces": full, "compact": full if texels is None else int(texels),
             "fused": 0}[mode]
    return 4 * (pano_h * pano_w + faces + width * height)


def equirect_table_bytes(platesize, width, height, mode="compact", bilinear=True,
                         texels=None) -> int:
    """K10's static operands, which every lane shares: 8 bytes a tap and
    output (index and weight; 4 for nearest, which has no weights) and the
    4-byte plate mask of an ingest, over every face texel (``"faces"``), the
    compacted texels plus the 4-byte compacted remap index a pixel
    (``"compact"``), or the screen's pixels (``"fused"``, no mask)."""
    per_tap = 8 * 4 if bilinear else 4
    full = MAX_PLATES * platesize * platesize
    if mode == "fused":
        return per_tap * width * height
    n = full if (mode == "faces" or texels is None) else int(texels)
    return (per_tap + 4) * n + (4 * width * height if mode == "compact" else 0)


def equirect_feasible_batch(pano_h, pano_w, platesize, width, height,
                            mode="compact", bilinear=True, texels=None, *,
                            device="cuda", budget=None) -> int:
    """The largest pano batch ``Session.render_equirect`` fits in *mode*:
    the budget (by default :func:`free_budget_bytes` of *device*) less
    the tables, over a lane's bytes."""
    budget = free_budget_bytes(device) if budget is None else int(budget)
    tables = equirect_table_bytes(platesize, width, height, mode, bilinear, texels)
    return feasible_batch(
        equirect_bytes_per_lane(pano_h, pano_w, platesize, width, height, mode, texels),
        0, budget=max(budget - tables, 0))
