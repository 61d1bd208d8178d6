"""Stereographic lens: r = tan(theta/2), full-sphere capable.

Reference: ``game/lua-scripts/lenses/stereographic.lua`` (angleScale = 0.5).
"""

from blinky_tpu_torch import xmath as m

_ANGLE_SCALE = 0.5


def make(ctx):
    def lens_inverse(x, y):
        r = m.sqrt(x * x + y * y)
        theta = m.atan(r) / _ANGLE_SCALE
        s = m.sin(theta)
        return x / r * s, y / r * s, m.cos(theta), True

    def lens_forward(x, y, z):
        theta = m.acos(z)
        r = m.tan(theta * _ANGLE_SCALE)
        c = r / m.sqrt(x * x + y * y)
        return x * c, y * c, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=360,
        onload="f_fov 180",
    )
