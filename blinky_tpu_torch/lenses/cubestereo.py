"""Cube-then-stereographic lens: rays projected onto the unit cube, then
stereographically to the plane.

Reference: ``game/lua-scripts/lenses/cubestereo.lua``.
"""

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import normalize


def _project_cube(x, y, z):
    """``projectcube`` (cubestereo.lua:7-19): divide by the dominant-axis
    magnitude; x wins ties over y wins ties over z, per the Lua if-chain."""
    magx, magy, magz = m.abs(x), m.abs(y), m.abs(z)
    use_x = (magx >= magy) & (magx >= magz)
    use_y = ~use_x & (magy >= magx) & (magy >= magz)
    mag = m.where(use_x, magx, m.where(use_y, magy, magz))
    return x / mag, y / mag, z / mag


def make(ctx):
    def lens_forward(x, y, z):
        px, py, pz = _project_cube(x, y, z)
        return px / (pz + 1) * 2, py / (pz + 1) * 2, True

    def lens_inverse(x, y):
        magx, magy = m.abs(x), m.abs(y)
        z = 2.0
        inside = (magx <= 1) & (magy <= 1)
        x_dom = ~inside & (magx > magy)
        rx = m.where(inside, x, m.where(x_dom, x / magx, x / magy))
        ry = m.where(inside, y, m.where(x_dom, y / magx, y / magy))
        rz = m.where(inside, z - 1, m.where(x_dom, z / magx - 1, z / magy - 1))
        vx, vy, vz = normalize(rx, ry, rz)
        return vx, vy, vz, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=270,
        max_vfov=270,
        onload="f_fov 180",
    )
