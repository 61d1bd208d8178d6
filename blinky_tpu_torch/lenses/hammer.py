"""Hammer (Hammer-Aitoff) equal-area projection, elliptical boundary.

Reference: ``game/lua-scripts/lenses/hammer.lua``.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon


def make(ctx):
    def lens_inverse(x, y):
        valid = ~(x * x / 8 + y * y / 2 > 1)
        z = m.sqrt(1 - 0.0625 * x * x - 0.25 * y * y)
        lon = 2 * m.atan(z * x / (2 * (2 * z * z - 1)))
        lat = m.asin(z * y)
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        den = m.sqrt(1 + m.cos(lat) * m.cos(lon * 0.5))
        px = 2 * math.sqrt(2) * m.cos(lat) * m.sin(lon * 0.5) / den
        py = math.sqrt(2) * m.sin(lat) / den
        return px, py, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * math.sqrt(2) * 2,
        lens_height=math.sqrt(2) * 2,
        onload="f_contain",
    )
