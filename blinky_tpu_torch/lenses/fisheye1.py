"""Equidistant fisheye: r = theta.

Reference: ``game/lua-scripts/lenses/fisheye1.lua``.
"""

from blinky_tpu_torch import xmath as m


def make(ctx):
    def lens_inverse(x, y):
        r = m.sqrt(x * x + y * y)
        valid = ~(r > m.pi)
        theta = r
        s = m.sin(theta)
        return x / r * s, y / r * s, m.cos(theta), valid

    def lens_forward(x, y, z):
        theta = m.acos(z)
        r = theta
        c = r / m.sqrt(x * x + y * y)
        return x * c, y * c, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=360,
        lens_width=2 * m.pi,
        lens_height=2 * m.pi,
        onload="f_contain",
    )
