"""Scalar-loop oracle for the lensmap build and the per-frame remap.

Each function is a line-faithful transcription of the corresponding
reference loop, evaluated per pixel in NumPy float64 (standing in for the
reference's double-precision Lua/C math).  Deliberately slow — use small
sizes in tests.
"""

from __future__ import annotations

import math

import numpy as np

from blinky_tpu_torch.lensmap.builder import TINT_NONE
from blinky_tpu_torch.palette import MAX_PLATES


def _normalize(ray):
    """``VectorNormalize`` (``engine/common/mathlib.c:412-429``) on vec_t =
    float32 components: float32 sum of squares, the double ``sqrt`` result
    truncated back to float32, float32 reciprocal and multiplies."""
    v = [np.float32(c) for c in ray]
    sumsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]  # f32, left-to-right
    length = np.float32(math.sqrt(np.float64(sumsq)))
    if length:  # NaN is truthy, exactly like C's if (length)
        ilength = np.float32(1.0) / length
        return [c * ilength for c in v]
    return v


def _ray_to_plate_index(globe, ray):
    """``ray_to_plate_index`` (``fisheye.c:2023-2050``): DotProduct of two
    float32 vectors evaluates in float32, compared in double."""
    if globe.plate_resolver is not None:
        p = globe.plate_resolver(
            np.float64(ray[0]), np.float64(ray[1]), np.float64(ray[2]), globe
        )
        return int(p)
    max_dp = -2.0
    plate_index = 0
    for i in range(globe.numplates):
        dp = float(
            ray[0] * globe.forward[i, 0]
            + ray[1] * globe.forward[i, 1]
            + ray[2] * globe.forward[i, 2]
        )  # f32 arithmetic (ray and forward are float32), then promoted
        if dp > max_dp:
            max_dp = dp
            plate_index = i
    return plate_index


def _ray_to_plate_uv(globe, plate, ray):
    """``ray_to_plate_uv`` (``fisheye.c:2052-2066``): float32 dots promoted
    to double, dist recomputed in double from the float32-stored fov."""
    r_, u_, f_ = globe.right[plate], globe.up[plate], globe.forward[plate]
    x = np.float64(r_[0] * ray[0] + r_[1] * ray[1] + r_[2] * ray[2])
    y = np.float64(u_[0] * ray[0] + u_[1] * ray[1] + u_[2] * ray[2])
    z = np.float64(f_[0] * ray[0] + f_[1] * ray[1] + f_[2] * ray[2])
    dist = 0.5 / math.tan(float(globe.fov_rad[plate]) / 2)
    with np.errstate(all="ignore"):
        u = x / z * dist + 0.5
        v = -y / z * dist + 0.5
    ok = (u >= 0) and (u <= 1) and (v >= 0) and (v <= 1)
    return float(u), float(v), bool(ok)


def _on_rubix_grid(px, py, platesize, numcells, cell_size, pad_size):
    """``set_lensmap_grid`` (``fisheye.c:1922-1960``)."""
    block_size = pad_size + cell_size
    num_units = numcells * block_size + pad_size
    unit_size_px = platesize / num_units
    ux = px / unit_size_px
    uy = py / unit_size_px
    return math.fmod(ux, block_size) < pad_size or math.fmod(uy, block_size) < pad_size


def oracle_inverse_lensmap(
    lens,
    globe,
    scale: float,
    width_px: int,
    height_px: int,
    platesize: int,
    numcells: int = 10,
    cell_size: float = 4.0,
    pad_size: float = 1.0,
):
    """``resume_lensmap_inverse`` (``fisheye.c:2084-2124``) +
    ``set_lensmap_from_ray/_plate_uv/_plate`` (``fisheye.c:1963-2013``),
    one pixel at a time.  Returns dict of [H, W] arrays matching
    :class:`blinky_tpu_torch.lensmap.LensMap` fields."""
    S = platesize
    plate_a = np.full((height_px, width_px), -1, dtype=np.int32)
    px_a = np.zeros((height_px, width_px), dtype=np.int32)
    py_a = np.zeros((height_px, width_px), dtype=np.int32)
    tint_a = np.full((height_px, width_px), TINT_NONE, dtype=np.uint8)
    used = np.zeros(MAX_PLATES, dtype=bool)

    for ly in range(height_px - 1, -1, -1):
        y = -(ly - height_px // 2) * scale
        for lx in range(width_px):
            x = (lx - width_px // 2) * scale
            with np.errstate(all="ignore"):
                rx, ry, rz, ok = lens.inverse(np.float64(x), np.float64(y))
            if not bool(np.asarray(ok)):
                continue
            ray = _normalize([float(rx), float(ry), float(rz)])
            plate = _ray_to_plate_index(globe, ray)
            if plate < 0:
                continue
            u, v, ok = _ray_to_plate_uv(globe, plate, ray)
            if not ok:
                continue
            px = int(u * S)  # C truncation, fisheye.c:1988
            py = int(v * S)
            if px < 0 or px >= S or py < 0 or py >= S:
                continue
            used[plate] = True
            plate_a[ly, lx] = plate
            px_a[ly, lx] = px
            py_a[ly, lx] = py
            if not _on_rubix_grid(px, py, S, numcells, cell_size, pad_size):
                tint_a[ly, lx] = plate

    valid = plate_a >= 0
    flat_idx = np.where(valid, plate_a * (S * S) + py_a * S + px_a, 0).astype(np.int32)
    return dict(
        plate=plate_a,
        px=np.where(valid, px_a, 0),
        py=np.where(valid, py_a, 0),
        valid=valid,
        tint=tint_a,
        flat_idx=flat_idx,
        plates_used=used,
    )


def oracle_remap(
    lensmap: dict,
    frames: np.ndarray,
    background: np.ndarray,
    rubix_enabled: bool = False,
    palmap: np.ndarray | None = None,
):
    """``render_lensmap`` (``fisheye.c:2406-2424``) over a [P, S, S] frame:
    invalid lensmap pixels show the background (the reference's
    ``Draw_TileClear`` underlay, ``fisheye.c:802``); valid ones chase the
    plate pixel, optionally through the tint palette."""
    H, W = lensmap["valid"].shape
    out = np.array(background, dtype=np.uint8, copy=True)
    for y in range(H):
        for x in range(W):
            if not lensmap["valid"][y, x]:
                continue
            val = frames[
                lensmap["plate"][y, x], lensmap["py"][y, x], lensmap["px"][y, x]
            ]
            if rubix_enabled:
                t = int(lensmap["tint"][y, x])
                if t != TINT_NONE:
                    val = palmap[t][val]
            out[y, x] = val
    return out
