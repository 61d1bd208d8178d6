"""Wagner VI projection (forward-only).

Reference: ``game/lua-scripts/lenses/wagner6.lua``.
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import ray_to_latlon


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        return lon * m.sqrt(1 - 3 * lat * lat / (m.pi * m.pi)), lat, True

    return dict(
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=m.pi * 2,
        lens_height=m.pi,
        onload="f_contain",
    )
