"""The inverse lensmap from the lens and globe equations: zoom solve,
screen -> lens plane -> ray, plate choice, plate texel, at the identity
view.

``create_lensmap`` / ``resume_lensmap_inverse`` (``fisheye.c:2084-2124``),
``calc_zoom`` (``fisheye.c:1293-1386``), ``ray_to_plate_index`` /
``ray_to_plate_uv`` (``fisheye.c:2023-2066``) and ``VectorNormalize``
(``mathlib.c:412-429``), written for tensors on any device.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Globe:
    forward: np.ndarray  # [n, 3] float32, as the script gives it
    right: np.ndarray  # [n, 3] float32, up x forward
    up: np.ndarray  # [n, 3] float32, forward x right
    fov_rad: np.ndarray  # [n] float32
    dist: np.ndarray  # [n] float32, 0.5 / tan(fov / 2)

    @property
    def numplates(self) -> int:
        return len(self.forward)


def lens(name: str):
    """The lens module ``lens_<name>.py`` beside this file."""
    return importlib.import_module(f"{__package__}.lens_{name}")


def globe(name: str) -> Globe:
    """The globe ``globe_<name>.py`` beside this file, with the loader's
    float32 frames (``fisheye.c:1849-1868``): ``right = up x forward``,
    ``up = forward x right``, no normalisation."""
    plates = importlib.import_module(f"{__package__}.globe_{name}").PLATES
    fwd = np.array([p[0] for p in plates], np.float32)
    up_in = np.array([p[1] for p in plates], np.float32)
    right = np.cross(up_in, fwd).astype(np.float32)
    up = np.cross(fwd, right).astype(np.float32)
    fov = (np.array([p[2] for p in plates], np.float64) * np.pi / 180).astype(np.float32)
    dist = np.array([0.5 / math.tan(float(f) / 2) for f in fov], np.float32)
    return Globe(fwd, right, up, fov, dist)


def fov_scale(lens_name: str, fov_deg: int, width: int) -> float:
    """``f_fov``'s lens-plane units per pixel: the probe ray at latitude 0,
    longitude fov/2, stored as float (a ``vec3_t``), mapped forward through
    the lens (its inputs as float, the sum of squares in float), flushed to
    the screen's half width."""
    lon = fov_deg * math.pi / 180 * 0.5
    ray = [float(np.float32(c)) for c in (math.sin(lon), 0.0, math.cos(lon))]
    x32, y32, z32 = (np.float32(c) for c in ray)
    sumsq = float(x32 * x32 + z32 * z32)
    lon_f = math.atan2(float(x32), float(z32))
    lat_f = math.atan2(float(y32), math.sqrt(sumsq))
    return lens(lens_name).forward_x(lat_f, lon_f, math) / (width * 0.5)


def build(lens_name: str, globe_name: str, fov_deg: int, width: int, height: int,
          platesize: int, *, hi=torch.float64, device="cpu"):
    """The lensmap of *lens_name* on *globe_name* at ``f_fov fov_deg``.

    *hi* is the precision of what the C engine computes in double (the lens
    math, the plate uv); what it stores as float (the ray, the plate frames,
    their dot products) is float32.  Returns (flat_idx int64 [n], valid bool
    [n]) over the screen's pixels in row-major order; ``flat_idx`` indexes
    the ``[6, S, S]`` plates, ``plate * S*S + row * S + column``, and is 0
    where the pixel is not valid."""
    g = globe(globe_name)
    S = platesize
    lo = torch.float32
    scale = torch.tensor(fov_scale(lens_name, fov_deg, width), dtype=hi, device=device)
    lx = torch.arange(width, dtype=torch.int32, device=device)
    ly = torch.arange(height, dtype=torch.int32, device=device)
    x = ((lx - width // 2).to(hi) * scale)[None, :].expand(height, width)
    y = (-(ly - height // 2).to(hi) * scale)[:, None].expand(height, width)
    lat, lon = lens(lens_name).inverse(x, y, torch)
    clat = torch.cos(lat)
    vx, vy, vz = torch.sin(lon) * clat, torch.sin(lat), torch.cos(lon) * clat
    # VectorNormalize on float components, its square root in double
    vx, vy, vz = vx.to(lo), vy.to(lo), vz.to(lo)
    sumsq = vx * vx + vy * vy + vz * vz
    length = torch.sqrt(sumsq.to(torch.float64)).to(lo)
    one = torch.ones_like(length)
    inv = torch.where(length != 0, one / torch.where(length != 0, length, one), one)
    vx, vy, vz = vx * inv, vy * inv, vz * inv

    def dot(vecs, k):
        c = torch.from_numpy(vecs[k]).to(dtype=lo, device=device)
        return vx * c[0] + vy * c[1] + vz * c[2]

    n = g.numplates
    dots = [dot(g.forward, k) for k in range(n)]
    best = dots[0]
    plate = torch.zeros(best.shape, dtype=torch.int64, device=device)
    for k in range(1, n):
        won = dots[k] > best  # the first maximum wins
        best = torch.where(won, dots[k], best)
        plate = torch.where(won, k, plate)
    rz = dots[0]
    rx, ry = dot(g.right, 0), dot(g.up, 0)
    for k in range(1, n):
        sel = plate == k
        rz = torch.where(sel, dots[k], rz)
        rx = torch.where(sel, dot(g.right, k), rx)
        ry = torch.where(sel, dot(g.up, k), ry)
    dists = torch.tensor([0.5 / math.tan(float(f) / 2) for f in g.fov_rad],
                         dtype=hi, device=device)
    dist = dists[plate]
    rx, ry, rz = rx.to(hi), ry.to(hi), rz.to(hi)
    nz = rz != 0
    den = torch.where(nz, rz, torch.ones_like(rz))
    u = torch.where(nz, rx / den, 0.0) * dist + 0.5
    v = torch.where(nz, -ry / den, 0.0) * dist + 0.5
    ok = nz & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    px = (torch.where(ok, u, 0.0) * S).to(torch.int64)  # truncation
    py = (torch.where(ok, v, 0.0) * S).to(torch.int64)
    valid = ok & (px >= 0) & (px < S) & (py >= 0) & (py < S)
    flat = torch.where(valid, plate * (S * S) + py * S + px, 0)
    return flat.reshape(-1), valid.reshape(-1)
