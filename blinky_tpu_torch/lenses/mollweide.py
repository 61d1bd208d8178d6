"""Mollweide equal-area projection.

Reference: ``game/lua-scripts/lenses/mollweide.lua``.  The forward map
solves ``t + sin t = pi sin lat`` by Newton iteration with the script's
exact (signed!) exit test ``dt < 0.001`` — reproduced per element via
:func:`blinky_tpu_torch.xmath.repeat_until`.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon

_ROOT2 = math.sqrt(2)


def _solve_theta(lat):
    # lat rides in the state so the NumPy active-set path can compact it
    # together with t (repeat_until's elementwise contract)
    def body(state):
        t, lat_ = state
        dt = -(t + m.sin(t) - m.pi * m.sin(lat_)) / (1 + m.cos(t))
        return (t + dt, lat_), dt < 0.001

    t, _ = m.repeat_until(body, (lat, lat), max_iter=100)
    return t / 2


def make(ctx):
    def lens_inverse(x, y):
        valid = ~(x * x / 8 + y * y / 2 > 1)
        t = m.asin(y / _ROOT2)
        lon = m.pi * x / (2 * _ROOT2 * m.cos(t))
        lat = m.asin((2 * t + m.sin(2 * t)) / m.pi)
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        t = _solve_theta(lat)
        px = 2 * _ROOT2 / m.pi * lon * m.cos(t)
        py = _ROOT2 * m.sin(t)
        return px, py, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * _ROOT2 * 2,
        lens_height=_ROOT2 * 2,
        onload="f_contain",
    )
