"""Eckert I projection (forward-only).

Reference: ``game/lua-scripts/lenses/eckert1.lua`` (the script also sets
unused ``hsym``/``vsym`` globals — not part of the loader contract).
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import ray_to_latlon

_FC = 0.92131773192356127802
_RP = 0.31830988618379067154


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        return _FC * lon * (1 - _RP * m.abs(lat)), _FC * lat, True

    return dict(
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=_FC * m.pi * 2,
        lens_height=_FC * m.pi,
        onload="f_contain",
    )
