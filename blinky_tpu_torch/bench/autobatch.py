"""Memory-aware batch sizing for the bench suite: how many lanes a bench run
may take.

The port of :mod:`blinky_tpu.bench.autobatch`'s bench planner.  A bench
process owns the card, so it plans on the card's whole memory
(:func:`device_hbm_bytes`) times :data:`EFFECTIVE_FRACTION`, measured by
the calibrate walk (:mod:`blinky_tpu_torch.bench.calibrate`), and rounds
the batch down to :data:`QUANTUM` lanes, as the JAX suite does.  The
bench's callers pass both themselves to the Session's planner,
:func:`blinky_tpu_torch.budget.feasible_batch`:
``feasible_batch(..., budget=effective_budget_bytes(dev), quantum=QUANTUM)``.
A Session call plans on free memory instead, in
:mod:`blinky_tpu_torch.budget`, which also holds the byte models a call
uses (plate planes, screen, posed, sweep, script); the ones here serve
only the bench's layouts (row-cropped, texel-compacted) and its 360°
sizing (the ``equirect_*`` models).

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

from blinky_tpu_torch.budget import feasible_batch, free_budget_bytes
from blinky_tpu_torch.palette import MAX_PLATES

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


def rows_bytes_per_lane(nrows, platesize, rgba=False) -> int:
    """Row-cropped stack ``[R_rows, S, B]`` (``kernels.remap.compact_rows``)."""
    return nrows * platesize * (4 if rgba else 1)


def texels_bytes_per_lane(ntexels, rgba=False) -> int:
    """Texel-compacted source ``[R, B]`` (``kernels.remap.compact_texels``);
    R counts only the texels the lensmap reads, rubix included."""
    return ntexels * (4 if rgba else 1)


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
