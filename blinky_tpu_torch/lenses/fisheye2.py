"""Equisolid-angle fisheye: r = 2 sin(theta/2).

Reference: ``game/lua-scripts/lenses/fisheye2.lua``.
"""

import math

from blinky_tpu_torch import xmath as m

_MAXR = 2 * math.sin(math.pi * 0.5)


def make(ctx):
    def lens_inverse(x, y):
        r = m.sqrt(x * x + y * y)
        valid = ~(r > _MAXR)
        theta = 2 * m.asin(r * 0.5)
        s = m.sin(theta)
        return x / r * s, y / r * s, m.cos(theta), valid

    def lens_forward(x, y, z):
        theta = m.acos(z)
        r = 2 * m.sin(theta * 0.5)
        c = r / m.sqrt(x * x + y * y)
        return x * c, y * c, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=360,
        lens_width=_MAXR * 2,
        lens_height=_MAXR * 2,
        onload="f_contain",
    )
