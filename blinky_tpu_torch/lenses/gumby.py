"""Gumby: panini with angles scaled by 0.75, bounds probed at load time.

Reference: ``game/lua-scripts/lenses/gumby.lua`` (computes ``lens_width`` /
``lens_height`` by forward-mapping the pole and the antipode at load,
mirroring the Lua script's top-level probes at ``gumby.lua:31-35``).
"""

import math

from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon
from blinky_tpu_torch.lenses.panini import panini_forward_xy, panini_inverse_latlon

_SCALE = 0.75
_SCALE_INV = 1.0 / _SCALE


def _forward(x, y, z):
    lat, lon = ray_to_latlon(x, y, z)
    px, py = panini_forward_xy(lat * _SCALE, lon * _SCALE)
    return px, py, True


def make(ctx):
    def lens_inverse(x, y):
        lat, lon = panini_inverse_latlon(x, y)
        vx, vy, vz = latlon_to_ray(lat * _SCALE_INV, lon * _SCALE_INV)
        return vx, vy, vz, True

    # load-time probes go through the float32 C builtin (gumby.lua:31-35)
    from blinky_tpu_torch.geometry import latlon_to_ray_f32

    hx, hy, _ = _forward(*latlon_to_ray_f32(math.pi / 2, 0.0))
    wx, wy, _ = _forward(*latlon_to_ray_f32(0.0, math.pi))
    return dict(
        lens_inverse=lens_inverse,
        lens_forward=_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=float(wx) * 2,
        lens_height=float(hy) * 2,
        onload="f_contain",
    )
