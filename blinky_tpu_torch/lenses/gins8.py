"""Ginsburg VIII (TsNIIGAiK) projection (forward-only).

Reference: ``game/lua-scripts/lenses/gins8.lua`` — lens bounds computed at
load time by forward-mapping the antipode and the pole
(``gins8.lua:21-24``).
"""

import math

from blinky_tpu_torch.geometry import ray_to_latlon

_CL = 0.000952426
_CP = 0.162388
_C12 = 0.08333333333333333


def _forward(x, y, z):
    lat, lon = ray_to_latlon(x, y, z)
    t = lat * lat
    py = lat * (1 + t * _C12)
    px = lon * (1 - _CP * t)
    t = lon * lon
    px = px * (0.87 - _CL * t * t)
    return px, py, True


def make(ctx):
    # load-time probes go through the float32 C builtin (gins8.lua:21-24)
    from blinky_tpu_torch.geometry import latlon_to_ray_f32

    wx, _, _ = _forward(*latlon_to_ray_f32(0.0, math.pi))
    _, hy, _ = _forward(*latlon_to_ray_f32(math.pi / 2, 0.0))
    return dict(
        lens_forward=_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * abs(float(wx)),
        lens_height=2 * abs(float(hy)),
        onload="f_contain",
    )
