"""Rectilinear (gnomonic / standard perspective) lens.

Reference: ``game/lua-scripts/lenses/rectilinear.lua`` — azimuthal with
r = tan(theta).  Default view ``f_fov 110`` (popular Quake FOVs).
"""

from blinky_tpu_torch import xmath as m


def make(ctx):
    def lens_inverse(x, y):
        r = m.sqrt(x * x + y * y)
        theta = m.atan(r)
        s = m.sin(theta)
        return x / r * s, y / r * s, m.cos(theta), True

    def lens_forward(x, y, z):
        theta = m.acos(z)
        r = m.tan(theta)
        c = r / m.sqrt(x * x + y * y)
        return x * c, y * c, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=180,
        max_vfov=180,
        onload="f_fov 110",
    )
