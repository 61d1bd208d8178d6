"""Eckert IV equal-area projection.

Reference: ``game/lua-scripts/lenses/eckert4.lua`` — fixed 20-iteration
Newton solve for theta (the Lua commented out its convergence test,
``eckert4.lua:2-11``), load-time probes for maxy / lens bounds.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon


def _solve_theta(lat):
    t = lat / 2
    for _ in range(20):
        dt = -(
            t + m.sin(t) * m.cos(t) + 2 * m.sin(t) - (2 + m.pi * 0.5) * m.sin(lat)
        ) / (2 * m.cos(t) * (1 + m.cos(t)))
        t = t + dt
    return t


_T_POLE = _solve_theta(math.pi * 0.5)
_MAXY = 2 * math.sqrt(math.pi / (4 + math.pi)) * math.sin(_T_POLE)
_T0 = _solve_theta(0.0)
_WIDTH = 2 / math.sqrt(math.pi * (4 + math.pi)) * math.pi * (1 + math.cos(_T0)) * 2


def make(ctx):
    def _max_x(lat):
        # get_max_x (eckert4.lua:14-21) without its scalar row cache, which
        # is a pure memoization — the value depends only on lat.
        t = _solve_theta(m.abs(lat))
        return 2 / m.sqrt(m.pi * (4 + m.pi)) * m.pi * (1 + m.cos(t))

    def lens_inverse(x, y):
        t = m.asin(y / 2 * m.sqrt((4 + m.pi) / m.pi))
        lat = m.asin((t + m.sin(t) * m.cos(t) + 2 * m.sin(t)) / (2 + m.pi * 0.5))
        lon = m.sqrt(m.pi * (4 + m.pi)) * x / (2 * (1 + m.cos(t)))
        valid = ~((m.abs(y) > _MAXY) | (m.abs(x) > _max_x(lat)))
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        t = _solve_theta(lat)
        px = 2 / m.sqrt(m.pi * (4 + m.pi)) * lon * (1 + m.cos(t))
        py = 2 * m.sqrt(m.pi / (4 + m.pi)) * m.sin(t)
        return px, py, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=_WIDTH,
        lens_height=2 * _MAXY,
        onload="f_contain",
    )
