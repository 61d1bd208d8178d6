"""Unfolded-cube ("cross") lens: the sphere shown as a 4x3 cube unwrap.

Reference: ``game/lua-scripts/lenses/cube.lua`` — inverse decodes the
row/column cell of the cross layout (``cube.lua:30-68``); forward projects
onto the dominant cube face (used only for FOV zoom).
"""

from blinky_tpu_torch import xmath as m

_COLS = 4
_ROWS = 3


def _cell(n):
    """Lua ``col``/``row`` helper (``cube.lua:14-28``): shifted modf with
    the negative-side fixup ``(i-1, f+1)``."""
    i, f = m.modf(n)
    neg = n < 0
    return m.where(neg, i - 1, i), m.where(neg, f + 1, f)


def make(ctx):
    def lens_inverse(x, y):
        x = x - 0.5
        r, v = _cell(-y + _ROWS / 2)
        c, u = _cell(x + _COLS / 2)
        u = u - 0.5
        v = -(v - 0.5)

        invalid = (r < 0) | (r >= _ROWS) | (c < -1) | (c >= _COLS)
        # top/bottom rows only exist above/below the front column (c == 1).
        invalid = invalid | (((r == 0) | (r == 2)) & (c != 1))

        # Face decode in the reference's branch order (cube.lua:44-67).
        vx = m.where(r == 0, u,
             m.where(r == 2, u,
             m.where(c == 0, -0.5,
             m.where(c == 1, u,
             m.where(c == 2, 0.5, -u)))))
        vy = m.where(r == 0, 0.5,
             m.where(r == 2, -0.5,
             m.where(c == 0, v,
             m.where(c == 1, v,
             m.where(c == 2, v, v)))))
        vz = m.where(r == 0, -v,
             m.where(r == 2, v,
             m.where(c == 0, u,
             m.where(c == 1, 0.5,
             m.where(c == 2, -u, -0.5)))))
        return vx, vy, vz, ~invalid

    def lens_forward(x, y, z):
        ax, ay, az = m.abs(x), m.abs(y), m.abs(z)
        mx = m.maximum(m.maximum(ax, ay), az)

        # Face selection follows the Lua elseif chain: ax wins ties, then ay.
        is_x = mx == ax
        is_y = ~is_x & (mx == ay)

        # x-dominant faces (right / left)
        ux = m.where(x > 0, -z / x * 0.5, z / -x * 0.5)
        vxf = m.where(x > 0, y / x * 0.5, y / -x * 0.5)
        px_x = m.where(x > 0, 1 + ux, -1 + ux)
        py_x = vxf

        # y-dominant faces (top / bottom)
        uy = m.where(y > 0, x / y * 0.5, x / -y * 0.5)
        vy_ = m.where(y > 0, -z / y * 0.5, z / -y * 0.5)
        px_y = uy
        py_y = m.where(y > 0, 1 + vy_, -1 + vy_)

        # z-dominant faces (front / back with the seam split, cube.lua:108-119)
        uz = m.where(z > 0, x / z * 0.5, -x / -z * 0.5)
        vz_ = m.where(z > 0, y / z * 0.5, y / -z * 0.5)
        px_z = m.where(z > 0, uz, m.where(uz > 0, -2 + uz, 2 + uz))
        py_z = vz_

        px = m.where(is_x, px_x, m.where(is_y, px_y, px_z))
        py = m.where(is_x, py_x, m.where(is_y, py_y, py_z))
        return px, py, True

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=_COLS,
        lens_height=_ROWS,
        onload="f_contain",
    )
