"""Gall stereographic projection.

Reference: ``game/lua-scripts/lenses/gallstereo.lua``.  Note the quirk kept
for parity: the forward map's bound check tests the *ray components*
against lens-plane bounds (``gallstereo.lua:18-21``), which never triggers
for unit rays — the function is effectively total.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon

_YF = 1.70710678118654752440
_XF = 0.70710678118654752440
_RYF = 0.58578643762690495119
_RXF = 1.41421356237309504880

_MAXX = _XF * math.pi
_MAXY = _YF * math.tan(0.5 * math.pi / 2)


def make(ctx):
    def lens_forward(x, y, z):
        valid = ~((m.abs(x) > _MAXX) | (m.abs(y) > _MAXY))
        lat, lon = ray_to_latlon(x, y, z)
        return _XF * lon, _YF * m.tan(0.5 * lat), valid

    def lens_inverse(x, y):
        lon = _RXF * x
        lat = 2 * m.atan(y * _RYF)
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=_MAXX * 2,
        lens_height=_MAXY * 2,
        onload="f_contain",
    )
