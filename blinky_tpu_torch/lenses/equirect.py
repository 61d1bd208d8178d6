"""Equirectangular (plate carrée) projection: x = lon, y = lat.

Reference: ``game/lua-scripts/lenses/equirect.lua``.
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon


def make(ctx):
    def lens_inverse(x, y):
        valid = ~((m.abs(y) > m.pi / 2) | (m.abs(x) > m.pi))
        vx, vy, vz = latlon_to_ray(y, x)
        return vx, vy, vz, valid

    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        return lon, lat, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * m.pi,
        lens_height=m.pi,
        onload="f_contain",
    )
