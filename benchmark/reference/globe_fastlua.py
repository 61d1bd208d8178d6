"""Blinky's two-plate ``fast`` globe (``game/lua-scripts/globes/fast.lua``)
from its equations, and the posed screens through it.

The script's plates (:data:`PLATES`, read by ``lensmap.globe("fastlua")``):
a sharp 90-degree plate and a wide 160-degree one, both facing +z with +y
up.  Its ``globe_plate(x, y, z)`` (:func:`globe_plate`): no plate where
``z <= 0``; else ``u = x / z * dist`` and ``v = y / z * dist`` with
``dist = 0.5 / tan(80 degrees)``, the wide plate's pinhole distance, and
plate 0 where ``|u| < half`` and ``|v| < half``, ``half = dist * tan(45
degrees)`` (half of the sharp plate's width on the wide plate's image
plane), else plate 1.  The script computes in Lua's doubles, so
:class:`FastLuaPosed` evaluates it in *hi*.

:class:`FastLuaPosed` is :class:`.posed.Posed` with the plate chosen by
:func:`globe_plate` instead of the largest forward dot: the camera rays,
each lane's turn into the world-aligned globe in *lo*, the chosen plate's
dots in *lo* and its uv in *hi*, the texel by truncation, the gather from
the lane's own two-plate frame ``[2, S, S, B]`` or the background, all as
there.  Departures from the engine are :mod:`.posed`'s; the script meets
the turned ray unnormalized, since its plate depends only on ``x / z``,
``y / z`` and the sign of ``z``.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

from . import posed

PLATES = [
    ((0, 0, 1), (0, 1, 0), 90),  # the sharp plate
    ((0, 0, 1), (0, 1, 0), 160),  # the wide plate
]
BIG_FOV = 160  # fast.lua's big_fov, degrees
DIST = 0.5 / math.tan(BIG_FOV * math.pi / 180 / 2)
HALF = 2 * DIST * math.tan(math.pi / 4) / 2  # fast.lua's size / 2


def globe_plate(x, y, z):
    """``globe_plate`` of fast.lua on tensors of one float dtype, its
    constants rounded to that dtype -> int64 plates, -1 where the script
    gives none."""
    dist = torch.tensor(DIST, dtype=x.dtype, device=x.device)
    half = torch.tensor(HALF, dtype=x.dtype, device=x.device)
    front = z > 0
    den = torch.where(front, z, torch.ones_like(z))
    u = x / den * dist
    v = y / den * dist
    small = (u.abs() < half) & (v.abs() < half)
    return torch.where(front, torch.where(small, 0, 1), -1).to(torch.int64)


class FastLuaPosed(posed.Posed):
    """The screens of lanes at their own poses through the fast globe:
    ``lens``, ``fov``, ``width``, ``height``, ``platesize`` of *cfg*; the
    globe is this module's whatever *cfg* names.  TF32 is set off, as a
    reference on the card must have it (it runs no product that would use
    it)."""

    def __init__(self, cfg: dict, device, *, hi=torch.float64, lo=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__({**cfg, "globe": "fastlua"}, device, hi=hi, lo=lo)

    def texels(self, bases):
        """*bases* ``[L, 3, 3]`` -> (flat index int64 ``[L, n]`` into the
        ``[2, S, S]`` plates, valid bool ``[L, n]``)."""
        R = torch.as_tensor(bases).to(device=self.device, dtype=self.lo)
        vx, vy, vz = self.rays

        def turn(j):  # component j of x * right + y * up + z * forward
            return vx * R[:, 1, j, None] + vy * R[:, 2, j, None] + vz * R[:, 0, j, None]

        wx, wy, wz = turn(0), turn(1), turn(2)
        plate = globe_plate(wx.to(self.hi), wy.to(self.hi), wz.to(self.hi))

        def dot(c):
            return wx * c[0] + wy * c[1] + wz * c[2]

        fwd, right, up = self.plates[0]
        rz, rx, ry = dot(fwd), dot(right), dot(up)
        for k, (fwd, right, up) in enumerate(self.plates[1:], 1):
            sel = plate == k
            rz = torch.where(sel, dot(fwd), rz)
            rx = torch.where(sel, dot(right), rx)
            ry = torch.where(sel, dot(up), ry)
        dist = self.dists[plate.clamp(min=0)]
        rx, ry, rz = rx.to(self.hi), ry.to(self.hi), rz.to(self.hi)
        nz = rz != 0
        den = torch.where(nz, rz, torch.ones_like(rz))
        u = torch.where(nz, rx / den, 0.0) * dist + 0.5
        v = torch.where(nz, -ry / den, 0.0) * dist + 0.5
        ok = (plate >= 0) & nz & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        S = self.S
        px = (torch.where(ok, u, 0.0) * S).to(torch.int64)  # truncation
        py = (torch.where(ok, v, 0.0) * S).to(torch.int64)
        valid = ok & (px >= 0) & (px < S) & (py >= 0) & (py < S)
        return torch.where(valid, plate * (S * S) + py * S + px, 0), valid
