"""Eckert V projection (forward-only).

Reference: ``game/lua-scripts/lenses/eckert5.lua``.
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import ray_to_latlon


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        return lon * (1 + m.cos(lat)) / 2, lat, True

    return dict(
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=m.pi * 2,
        lens_height=m.pi,
        onload="f_contain",
    )
