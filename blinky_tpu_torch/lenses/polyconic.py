"""American polyconic projection (forward-only), singular at lat = 0.

Reference: ``game/lua-scripts/lenses/polyconic.lua`` — the equator row is
special-cased to ``(lon, 0)``.
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import ray_to_latlon


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        cot = 1 / m.tan(lat)
        px = cot * m.sin(lon * m.sin(lat))
        py = lat + cot * (1 - m.cos(lon * m.sin(lat)))
        eq = lat == 0
        return m.where(eq, lon, px), m.where(eq, 0.0, py), True

    return dict(
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        onload="f_fov 360",
    )
