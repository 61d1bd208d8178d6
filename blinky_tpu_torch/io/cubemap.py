"""Cubemap (globe plate) import/export and synthetic fixtures.

The reference's frame source is the Quake software renderer filling the
vid buffer per plate (``render_plate``, ``engine/NQ/fisheye.c:2427-2450``)
and its export is ``f_saveglobe`` -> per-plate PCX with other-plate texels
masked to 0xFE unless "full" (``WritePCXplate``, ``fisheye.c:1441-1443``).
The port consumes recorded/synthetic plates as NumPy arrays, exactly as
:mod:`blinky_tpu.io.cubemap` does; frames become tensors at the remap.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from blinky_tpu_torch import geometry
from blinky_tpu_torch.io.pcx import decode_pcx, encode_pcx
from blinky_tpu_torch.palette import MAX_PLATES

MASK_COLOR = 0xFE  # fisheye.c:1443


def plate_ownership_mask(globe, plate: int, platesize: int) -> np.ndarray:
    """True where a texel's corner ray resolves to *plate*.

    Mirrors the saveglobe mask: ``u = j/width, v = i/height`` (texel
    corners) -> ray -> ``ray_to_plate_index`` (``fisheye.c:1435-1443``).
    """
    S = platesize
    ts = np.arange(S, dtype=np.float64) / S
    U, V = np.meshgrid(ts, ts, indexing="xy")
    rx, ry, rz = geometry.plate_uv_to_ray_c(
        U, V, globe.forward[plate], globe.right[plate],
        globe.up[plate], globe.dist[plate], np, np.float32, np.float64,
    )
    if globe.plate_resolver is not None:
        owner = np.asarray(globe.plate_resolver(
            rx.astype(np.float64), ry.astype(np.float64), rz.astype(np.float64), globe
        ))
    else:
        owner = geometry.ray_to_plate_index_c(rx, ry, rz, globe.forward, np)
    return owner == plate


def save_globe_pcx(prefix, frames, globe, palette, with_margins: bool = False) -> list:
    """``f_saveglobe <name> [full]``: write ``<prefix><i>.pcx`` per plate
    (``cmd_saveglobe``/``save_globe``, ``fisheye.c:1120-1136,1467-1486``).

    Returns the written paths.
    """
    frames = np.asarray(frames, dtype=np.uint8)
    paths = []
    for i in range(globe.numplates):
        img = frames[i]
        if not with_margins:
            img = np.where(plate_ownership_mask(globe, i, img.shape[0]), img, MASK_COLOR)
        p = Path(f"{prefix}{i}.pcx")
        p.write_bytes(encode_pcx(img.astype(np.uint8), palette, mode="reference"))
        paths.append(p)
    return paths


def load_globe_pcx(prefix, numplates: int):
    """Read ``<prefix><i>.pcx`` back into a [MAX_PLATES, S, S] uint8 array
    (unused plates zero) plus the file palette."""
    imgs, palette = [], None
    for i in range(numplates):
        img, palette = decode_pcx(Path(f"{prefix}{i}.pcx").read_bytes())
        imgs.append(img)
    S = imgs[0].shape[0]
    out = np.zeros((MAX_PLATES, S, S), dtype=np.uint8)
    for i, img in enumerate(imgs):
        out[i] = img
    return out, palette


def synthetic_cubemap(platesize: int, numplates: int = 6, seed: int = 0) -> np.ndarray:
    """Deterministic procedural cubemap, [MAX_PLATES, S, S] uint8.

    Each plate gets a distinct checker + gradient + border pattern in
    palette-index space so remap errors (wrong plate, flipped axes,
    off-by-one) are visually and numerically obvious.
    """
    S = platesize
    py, px = np.mgrid[0:S, 0:S]
    out = np.zeros((MAX_PLATES, S, S), dtype=np.uint8)
    for p in range(numplates):
        checker = ((px // 8 + py // 8) % 2) * 16
        grad = (px * 3 + py * 5 + p * 37 + seed * 11) % 128
        border = (px < 2) | (py < 2) | (px >= S - 2) | (py >= S - 2)
        val = (p * 40 + 8 + checker + grad) % 255
        out[p] = np.where(border, 200 + p, val).astype(np.uint8)
    return out


def synthetic_cubemap_batch(platesize: int, batch: int, numplates: int = 6) -> np.ndarray:
    """Batched fixture in the native layout [MAX_PLATES, S, S, B] uint8;
    frame b is the base cubemap rolled by b pixels (cheap distinct frames,
    standing in for a recorded demo's frame stream)."""
    base = synthetic_cubemap(platesize, numplates)
    out = np.empty((MAX_PLATES, platesize, platesize, batch), dtype=np.uint8)
    for b in range(batch):
        out[..., b] = np.roll(base, b, axis=2)
    return out


def to_batch_layout(frames_bpss: np.ndarray) -> np.ndarray:
    """[B, P, S, S] -> device layout [P, S, S, B] (C++ packer when built).

    u8 palette frames go through the native packer; packed-RGBA uint32
    frames (true-color sources) transpose in NumPy — ingest-time cost."""
    from blinky_tpu_torch import native

    frames_bpss = np.asarray(frames_bpss)
    if frames_bpss.dtype == np.uint8:
        out = native.pack_batch(frames_bpss)
        if out is not None:
            return out
    return np.ascontiguousarray(np.moveaxis(frames_bpss, 0, -1))


def equirect_to_cubemap(pano, globe=None, platesize: int = 512,
                        bilinear: bool = True) -> np.ndarray:
    """Resample an equirectangular panorama into globe plates: the
    ingestion path for real 360° content (most 360 video is equirect,
    not cube faces).

    For every plate texel the pinhole ray (``plate_uv_to_ray``,
    ``fisheye.c:1198-1214``) is converted to lat/lon
    (``ray_to_latlon``, ``fisheye.c:1192``: lon 0 = forward +Z, +lon =
    right, +lat = up) and sampled from the panorama with the standard
    equirect convention (column = (lon+π)/2π · W wrapping, row =
    (π/2−lat)/π · H clamped).

    Args:
        pano: [H, W, 3] u8 RGB (→ packed-RGBA uint32 plates) or [H, W]
            u8 palette indices (→ u8 plates, nearest-neighbor only).
        globe: target plate layout (default: the cube globe).
        platesize: output plate resolution S.
        bilinear: RGB sources interpolate; palette sources always use
            nearest (indices don't blend).

    Returns [MAX_PLATES, S, S] uint32 (RGB input) or uint8 (palette
    input); plates beyond the globe's count stay zero.

    This is the single-pano host wrapper over
    :class:`blinky_tpu_torch.kernels.ingest.EquirectIngest`, all NumPy: the
    geometry lives in one static index/weight table shared with the batched
    device path (reuse the kernel object directly for video batches).
    """
    from blinky_tpu_torch.kernels.ingest import EquirectIngest
    from blinky_tpu_torch.kernels.remap import pack_rgba

    pano = np.asarray(pano, dtype=np.uint8)
    is_rgb = pano.ndim == 3
    if is_rgb and pano.shape[2] != 3:
        raise ValueError("equirect pano must be [H, W, 3] RGB or [H, W]")
    H, W = pano.shape[:2]
    kern = EquirectIngest(H, W, platesize, globe=globe,
                          bilinear=bool(is_rgb and bilinear))
    if is_rgb:
        return kern.host(pack_rgba(pano))
    return kern.host_nearest_u8(pano)
