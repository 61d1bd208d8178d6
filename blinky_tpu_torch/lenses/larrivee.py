"""Larrivée projection (forward-only).

Reference: ``game/lua-scripts/lenses/larrivee.lua``.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import ray_to_latlon


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        px = (0.5 + 0.5 * m.sqrt(m.cos(lat))) * lon
        py = lat / (m.cos(lat / 2) * m.cos(lon / 6))
        return px, py, True

    return dict(
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * math.pi,
        lens_height=math.pi / 2 / math.cos(math.pi / 2 / 2) * 2,
        onload="f_contain",
    )
