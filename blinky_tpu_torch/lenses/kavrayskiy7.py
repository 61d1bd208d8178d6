"""Kavrayskiy VII projection (forward-only).

Reference: ``game/lua-scripts/lenses/kavrayskiy7.lua``.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import ray_to_latlon


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        px = 3 * lon / (2 * m.pi) * m.sqrt(m.pi * m.pi / 3 - lat * lat)
        return px, lat, True

    return dict(
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=3 * math.pi / (2 * math.pi) * math.sqrt(math.pi * math.pi / 3) * 2,
        lens_height=math.pi,
        onload="f_contain",
    )
