"""The float32 device builder's bench tools: the zoom ramp of the sweep, the
operation and byte counts of the resolve kernels, and the timing of a warm
rebuild split into its lens stage and its resolve.

``chip_smoke.py`` uses them for the device-builder paths, beside
:mod:`blinky_tpu_torch.bench.posed` for the posed path.  The timings need a
card (CUDA events); the counts and the ramp do not.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from blinky_tpu_torch.lensmap import Zoom, calc_scale
from blinky_tpu_torch.lensmap import builder


def sweep_fovs(start=100.0, stop=330.0, steps=24) -> list:
    """The zoom ramp of ``blinky_tpu``'s ``cli sweep`` (its defaults: 24
    steps of ``f_fov`` from 100 to 330), each value as the console parses
    it: ``f_fov`` keeps the integer part."""
    return [int(float(f"{v:.6g}")) for v in np.linspace(start, stop, steps)]


def sweep_scales(lens, width_px, height_px, fovs) -> list:
    """The ramp's lens-plane scales, one ``calc_scale`` a step."""
    return [calc_scale(Zoom("fov", f), lens, width_px, height_px) for f in fovs]


def resolve_ops_per_pixel(globe, rotate=True) -> int:
    """Float32 operations the shared resolve (``csrc/resolve.cuh``) does
    for one ray: the rotation (9 mul, 6 add; none without *rotate*), the
    normalize (3 mul, 2 add, sqrt, compare, reciprocal, 3 mul), the plate
    choice (max-dot: a 5-op dot and a compare a plate, less one compare,
    whose winning dot is the chosen plate's forward dot; the fast globe: 2
    compares, 2 divisions, 2 mul, 2 abs, 2 compares, then the chosen plate's
    forward dot), the chosen plate's right and up dots, u and v (compare, 2
    divisions, 2 mul, 2 add; the sign flip of -ry is free), four range
    compares, the truncation (2 mul, 2 conversions).  A script globe's
    given plate (resolver mode 2): its clip (2 compares) and the chosen
    plate's forward dot; the script's own operations are not the
    kernel's."""
    n = globe.numplates
    choose = {"maxdot": 6 * n - 1, "fast": 10 + 5,
              "script": 2 + 5}[builder.plate_resolver_mode(globe)]
    return (15 if rotate else 0) + 11 + choose + 10 + 7 + 4 + 4


# what the rotate pre-pass (K13) does for one ray and pose: the rotation and
# the normalize of resolve_ops_per_pixel
ROTATE_OPS = 15 + 11


# what K8 moves a pixel: the ray and its mask in (and a script globe's int32
# plate, GIVEN_PLATE_BYTES more), the six tables out
RESOLVE_BYTES_IN = 13
GIVEN_PLATE_BYTES = 4
RESOLVE_BYTES_OUT = 4 * 4 + 2


def rebuild_ms(lens, globe, scale, width_px, height_px, platesize, device,
               view_basis=None, iters=10) -> dict:
    """A warm float32 rebuild on *device*, split: the lens stage and the
    resolve (K8) by CUDA events over *iters* runs each, the resolve's plain
    version beside it, and the whole ``build_lensmap(backend="torch")`` by
    the host's clock around a synchronise (what a caller waits for)."""
    from blinky_tpu_torch.bench.sol import cuda_ms

    dev = torch.device(device)
    basis = builder.IDENTITY_BASIS if view_basis is None else view_basis
    rays = builder.lens_rays_torch(lens, scale, width_px, height_px, dev)
    vb = torch.from_numpy(builder.basis_f32(basis)).to(dev)
    args = (globe, *rays, platesize, 10, 4.0, 1.0)
    out = {
        "lens_ms": cuda_ms(lambda: builder.lens_rays_torch(lens, scale, width_px, height_px,
                                                           dev), iters),
        "resolve_ms": cuda_ms(lambda: builder.lensmap_resolve(*args, basis), iters),
        "plain_ms": cuda_ms(lambda: builder.rays_to_lensmap_torch(*args, view_basis=vb),
                            max(iters // 3, 1)),
    }
    walls = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        builder.build_lensmap(lens, globe, scale, width_px, height_px, platesize,
                              backend="torch", view_basis=view_basis, device=dev)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["build_wall_ms"] = min(walls)
    return out


def lens_stage_peak_planes(lens, scale, width_px, height_px, device) -> float:
    """The lens stage's peak of live device memory for one scale, its rays
    included, in float32 planes a pixel (``torch.cuda.max_memory_allocated``
    above the level before the call): what
    :data:`blinky_tpu_torch.budget.SWEEP_LENS_PLANES` must cover."""
    dev = torch.device(device)
    builder.lens_rays_torch(lens, scale, width_px, height_px, dev)  # warm
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    rays = builder.lens_rays_torch(lens, scale, width_px, height_px, dev)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    del rays
    return peak / (4.0 * width_px * height_px)
