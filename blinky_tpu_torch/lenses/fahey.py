"""Fahey projection, elliptical boundary.

Reference: ``game/lua-scripts/lenses/fahey.lua``.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon

_XR = 0.819152 * math.pi
_YR = 1.819152


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        t = m.tan(0.5 * lat)
        py = 1.819152 * t
        px = 0.819152 * lon * m.sqrt(1 - t * t)
        return px, py, True

    def lens_inverse(x, y):
        valid = ~(x * x / (_XR * _XR) + y * y / (_YR * _YR) >= 1)
        t = y / 1.819152
        lat = 2 * m.atan(t)
        t2 = 1 - t * t
        lon = x / (0.819152 * m.sqrt(t2))
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=_XR * 2,
        lens_height=_YR * 2,
        onload="f_contain",
    )
