"""Central cylindrical projection: y = tan(lat).

Reference: ``game/lua-scripts/lenses/cylinder.lua``.
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon


def make(ctx):
    def lens_inverse(x, y):
        valid = ~(m.abs(x) > m.pi)
        lon = x
        lat = m.atan(y)
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        return lon, m.tan(lat), True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * m.pi,
        onload="f_cover",
    )
