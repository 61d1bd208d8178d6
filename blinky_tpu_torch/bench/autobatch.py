"""Memory-aware batch sizing: how many poses one posed call may take before
the Session splits the batch, and how many panos one equirect call fits.

The port of the part of :mod:`blinky_tpu.bench.autobatch` that
``Session.render_posed`` needs: :func:`feasible_batch` and the per-lane
byte models; and the equirect chain's own model
(:func:`equirect_bytes_per_lane`, :func:`equirect_feasible_batch`).  Each pipeline states its per-lane (per-pose) byte cost, and
the planner returns the largest batch that fits the device budget.

What replaces the JAX module's TPU constants:

* the budget is the card's own free memory, read from
  ``torch.cuda.mem_get_info`` when the call is planned (the JAX package
  reads the TPU's ``memory_stats`` or a documented v5e capacity), times
  :data:`BUDGET_FRACTION`;
* the v5e ``EFFECTIVE_FRACTION`` (1.0286: XLA kept ~3 % less live than
  that model counted) has no counterpart: PyTorch runs eagerly and
  allocates exactly the tensors the model counts, so the fraction is
  below 1 instead (see :data:`BUDGET_FRACTION`);
* the 128-lane ``QUANTUM`` was the TPU's minor tile dimension, on which the
  batch axis of the gathered rows lay.  The posed kernels take poses along
  their grid's second dimension, eight to a block, and a partial group
  costs nothing, so the batch is not rounded at all.

The calibrate walk that measured the v5e's boundary is not ported.
"""

from __future__ import annotations

import os

import torch

from blinky_tpu_torch.palette import MAX_PLATES

# Of the free memory, what a posed call may plan to fill.  The caching
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


def effective_budget_bytes(device) -> int:
    return int(device_memory_bytes(device) * BUDGET_FRACTION)


def feasible_batch(src_bytes_per_lane, out_bytes_per_lane, *, device="cuda",
                   budget=None) -> int:
    """Largest batch whose per-lane live set (source + output) fits the
    budget, by default :func:`effective_budget_bytes` of *device*.  Always
    >= 1, so callers can chunk by it."""
    budget = effective_budget_bytes(device) if budget is None else int(budget)
    per_lane = float(src_bytes_per_lane) + float(out_bytes_per_lane)
    return max(int(budget // max(per_lane, 1.0)), 1)


def screen_bytes_per_lane(width, height, rgba=False) -> int:
    """The materialized [H, W] screen, per lane."""
    return width * height * (4 if rgba else 1)


def planes_bytes_per_lane(planesize, nplanes, rgba=False, expanded=False) -> int:
    """[NP, S, S, B] plate-plane source on the device: one lane's bytes.  A
    P < MAX_PLATES source is zero-padded to MAX_PLATES planes, the
    expanded layout is always 2 * MAX_PLATES."""
    np_ = 2 * MAX_PLATES if expanded else max(nplanes, MAX_PLATES)
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
    the budget (by default :func:`effective_budget_bytes` of *device*) less
    the tables, over a lane's bytes."""
    budget = effective_budget_bytes(device) if budget is None else int(budget)
    tables = equirect_table_bytes(platesize, width, height, mode, bilinear, texels)
    return feasible_batch(
        equirect_bytes_per_lane(pano_h, pano_w, platesize, width, height, mode, texels),
        0, budget=max(budget - tables, 0))
