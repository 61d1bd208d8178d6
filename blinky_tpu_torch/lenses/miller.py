"""Miller cylindrical projection (modified Mercator).

Reference: ``game/lua-scripts/lenses/miller.lua``.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon

_MAXY = 1.25 * math.log(math.tan(0.25 * math.pi + 0.4 * math.pi * 0.5))


def make(ctx):
    def lens_inverse(x, y):
        valid = ~((m.abs(y) > _MAXY) | (m.abs(x) > m.pi))
        lon = x
        lat = 5.0 / 4.0 * m.atan(m.sinh(4.0 / 5.0 * y))
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        return lon, 1.25 * m.log(m.tan(0.25 * m.pi + 0.4 * lat)), True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * m.pi,
        lens_height=_MAXY * 2,
        onload="f_contain",
    )
