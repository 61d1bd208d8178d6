"""Equirect panoramas resampled to the globe's plates, bilinear: each
plate texel's centre as a ray (``plate_uv_to_ray``, ``fisheye.c:1198-1214``),
its latitude and longitude (``fisheye.c:1192``, the ray's components and
their sum of squares as float), the pano's row (clamped at the poles) and
column (wrapped), and four taps blended per colour channel."""

from __future__ import annotations

import math

import torch

from .lensmap import globe


def taps(globe_name: str, platesize: int, pano_h: int, pano_w: int, texels,
         *, hi=torch.float64, lo=torch.float32):
    """The four taps of each plate texel in *texels* (int64 ids into the
    ``[6, S, S]`` plates, on their device): (rows [4, n] int64 into the
    flattened ``[H*W]`` pano, weights [4, n] in *lo*, plate mask [n] bool,
    False on a plate the globe lacks).  The position math is in *hi*."""
    g = globe(globe_name)
    S, H, W = platesize, pano_h, pano_w
    dev = texels.device
    p = texels // (S * S)
    on_globe = p < g.numplates
    p = p.clamp(max=g.numplates - 1)
    u = ((texels % S).to(hi) + 0.5) / S
    v = ((texels // S % S).to(hi) + 0.5) / S

    def frame(vecs):
        return torch.from_numpy(vecs).to(dtype=hi, device=dev)[p]

    fwd, rgt, up = frame(g.forward), frame(g.right), frame(g.up)
    dist = torch.from_numpy(g.dist).to(dtype=hi, device=dev)[p]
    uu, vv = u - 0.5, -(v - 0.5)
    x = dist * fwd[:, 0] + uu * rgt[:, 0] + vv * up[:, 0]
    y = dist * fwd[:, 1] + uu * rgt[:, 1] + vv * up[:, 1]
    z = dist * fwd[:, 2] + uu * rgt[:, 2] + vv * up[:, 2]
    length = torch.sqrt(x * x + y * y + z * z)
    inv = torch.where(length != 0, 1.0 / torch.where(length != 0, length, 1.0), 1.0)
    x32, y32, z32 = (c.to(torch.float32) for c in (x * inv, y * inv, z * inv))
    sumsq = (x32 * x32 + z32 * z32).to(hi)
    lon = torch.atan2(x32.to(hi), z32.to(hi))
    lat = torch.atan2(y32.to(hi), torch.sqrt(sumsq))
    col = (lon + math.pi) / (2 * math.pi) * W
    row = (math.pi / 2 - lat) / math.pi * H
    c0 = torch.floor(col - 0.5).to(torch.int64)
    r0 = torch.floor(row - 0.5).to(torch.int64)
    fc = (col - 0.5 - c0).to(lo)
    fr = (row - 0.5 - r0).to(lo)
    rows, weights = [], []
    for dc, dr in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ri = (r0 + dr).clamp(0, H - 1)
        ci = torch.remainder(c0 + dc, W)
        rows.append(ri * W + ci)
        weights.append((fc if dc else 1 - fc) * (fr if dr else 1 - fr))
    return torch.stack(rows), torch.stack(weights), on_globe


def blend(pano_rows, weights, *, lo=torch.float32):
    """Four gathered taps (int32 packed RGBA bits, [4, n, L]) blended per
    colour channel: ``((c0 w0 + c1 w1) + c2 w2) + c3 w3``, each product and
    sum rounded in *lo* on its own, + 0.5, clipped to 0..255, truncated;
    alpha 0xFF.  Returns int32 bits [n, L]."""
    out = None
    for shift in (0, 8, 16):
        acc = None
        for k in range(4):
            term = ((pano_rows[k] >> shift) & 0xFF).to(lo) * weights[k][:, None].to(lo)
            acc = term if acc is None else acc + term
        ch = (acc.float() + 0.5).clamp(0, 255).to(torch.int32) << shift
        out = ch if out is None else out | ch
    return out | torch.tensor(-(1 << 24), dtype=torch.int32, device=out.device)
