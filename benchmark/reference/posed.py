"""Per-frame-pose playback from the equations: the lens's camera rays, each
lane's view rotation, the plate and texel that the rotated ray meets, and
that texel of the lane's own frame, or the background.

The rays are :mod:`.lensmap`'s, at the identity view: the lens math in
*hi* (double in the C engine), the unit ray stored in *lo* (``vec_t``),
normalized as ``VectorNormalize`` does.  Each lane's basis, rows (forward,
right, up), is input data like the frames (``benchmark/poses.py`` makes it
from the pose track); nothing here takes a table, a ray or a basis that
the program made.  Departures from the C engine:

* the engine renders a posed view by rotating the camera: ``F_RenderView``
  (``fisheye.c:750,777-792``) composes each plate's frame with the view's
  ``AngleVectors`` basis, and the static lensmap's rays meet the rotated
  plates.  Here the rays turn instead, into the world-aligned globe,
  ``x * right + y * up + z * forward`` in *lo* from the basis stored in
  *lo* (``vec3_t``); the two agree but for rounding;
* the rotated ray is not normalized again: the plate choice (the first
  largest forward dot) and the plate's uv (ratios of dots) do not depend on
  its length;
* the plate choice and the uv follow :mod:`.lensmap`: the dots in *lo*, the
  uv in *hi*, the texel by truncation.

The lanes go in blocks of :data:`BLOCK`, so that a check of thousands of
1080p lanes fits on the card beside the frames.
"""

from __future__ import annotations

import math

import torch

from . import lensmap

BLOCK = 32  # lanes a block


def camera_rays(lens_name: str, fov_deg: int, width: int, height: int, *, hi, lo, device):
    """The unit camera rays of the screen's pixels at ``f_fov fov_deg``,
    ``[3, height * width]`` in *lo*, row-major."""
    scale = torch.tensor(lensmap.fov_scale(lens_name, fov_deg, width), dtype=hi, device=device)
    lx = torch.arange(width, dtype=torch.int32, device=device)
    ly = torch.arange(height, dtype=torch.int32, device=device)
    x = ((lx - width // 2).to(hi) * scale)[None, :].expand(height, width)
    y = (-(ly - height // 2).to(hi) * scale)[:, None].expand(height, width)
    lat, lon = lensmap.lens(lens_name).inverse(x, y, torch)
    clat = torch.cos(lat)
    vx, vy, vz = (c.to(lo).reshape(-1) for c in
                  (torch.sin(lon) * clat, torch.sin(lat), torch.cos(lon) * clat))
    # VectorNormalize on float components, its square root in double
    sumsq = vx * vx + vy * vy + vz * vz
    length = torch.sqrt(sumsq.to(torch.float64)).to(lo)
    one = torch.ones_like(length)
    inv = torch.where(length != 0, one / torch.where(length != 0, length, one), one)
    return torch.stack([vx * inv, vy * inv, vz * inv])


class Posed:
    """The screens of lanes at their own poses, for one configuration:
    ``lens``, ``globe``, ``fov``, ``width``, ``height``, ``platesize``."""

    def __init__(self, cfg: dict, device, *, hi=torch.float64, lo=torch.float32):
        self.shape = (cfg["height"], cfg["width"])
        self.S = cfg["platesize"]
        self.hi, self.lo, self.device = hi, lo, device
        self.rays = camera_rays(cfg["lens"], cfg["fov"], cfg["width"], cfg["height"],
                                hi=hi, lo=lo, device=device)
        g = lensmap.globe(cfg["globe"])
        self.plates = [tuple(torch.from_numpy(v[k]).to(dtype=lo, device=device)
                             for v in (g.forward, g.right, g.up))
                       for k in range(g.numplates)]
        self.dists = torch.tensor([0.5 / math.tan(float(f) / 2) for f in g.fov_rad],
                                  dtype=hi, device=device)

    @property
    def pixels(self) -> int:
        """The screen's pixels: one ray each."""
        return self.rays.shape[1]

    def texels(self, bases):
        """*bases* ``[L, 3, 3]`` -> (flat index int64 ``[L, n]`` into the
        ``[6, S, S]`` plates, valid bool ``[L, n]``)."""
        R = torch.as_tensor(bases).to(device=self.device, dtype=self.lo)
        vx, vy, vz = self.rays

        def turn(j):  # component j of x * right + y * up + z * forward
            return vx * R[:, 1, j, None] + vy * R[:, 2, j, None] + vz * R[:, 0, j, None]

        wx, wy, wz = turn(0), turn(1), turn(2)

        def dot(c):
            return wx * c[0] + wy * c[1] + wz * c[2]

        best = dot(self.plates[0][0])
        plate = torch.zeros(best.shape, dtype=torch.int64, device=self.device)
        rz, rx, ry = best, dot(self.plates[0][1]), dot(self.plates[0][2])
        for k, (fwd, right, up) in enumerate(self.plates[1:], 1):
            d = dot(fwd)
            won = d > best  # the first maximum wins
            best = torch.where(won, d, best)
            plate = torch.where(won, k, plate)
            rz = torch.where(won, d, rz)
            rx = torch.where(won, dot(right), rx)
            ry = torch.where(won, dot(up), ry)
        dist = self.dists[plate]
        rx, ry, rz = rx.to(self.hi), ry.to(self.hi), rz.to(self.hi)
        nz = rz != 0
        den = torch.where(nz, rz, torch.ones_like(rz))
        u = torch.where(nz, rx / den, 0.0) * dist + 0.5
        v = torch.where(nz, -ry / den, 0.0) * dist + 0.5
        ok = nz & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        S = self.S
        px = (torch.where(ok, u, 0.0) * S).to(torch.int64)  # truncation
        py = (torch.where(ok, v, 0.0) * S).to(torch.int64)
        valid = ok & (px >= 0) & (px < S) & (py >= 0) & (py < S)
        return torch.where(valid, plate * (S * S) + py * S + px, 0), valid

    def screens(self, frames, bases, start: int, stop: int):
        """Lanes ``start:stop`` of *frames* ``[6, S, S, B]`` at *bases*
        ``[B, 3, 3]`` -> ``[stop - start, n]`` of the frames' dtype, palette
        colour 0 where no plate is valid."""
        flat, valid = self.texels(bases[start:stop])
        rows = frames.reshape(-1, frames.shape[-1])[:, start:stop].t()  # [L, 6*S*S], lane-strided
        out = torch.gather(rows, 1, flat)
        return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))

    def __call__(self, frames, bases):
        """Every lane -> ``[B, H, W]``, block by block."""
        B = frames.shape[-1]
        out = torch.empty((B,) + self.shape, dtype=frames.dtype, device=frames.device)
        for start in range(0, B, BLOCK):
            stop = min(start + BLOCK, B)
            out[start:stop] = self.screens(frames, bases, start, stop).reshape(
                (stop - start,) + self.shape)
        return out
