"""Van der Grinten projection.

Reference: ``game/lua-scripts/lenses/vandergrinten.lua`` — forward with the
equator / pole special cases; inverse by the closed-form cubic resolvent
with the script's TOL guards (``vandergrinten.lua:38-106``).  ``maxr`` and
the lens bounds come from the load-time probe ``lens_forward(ray(0, pi))``
(= pi via the equator branch).
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, ray_to_latlon

_TOL = 1.0e-10
_THIRD = 0.33333333333333333333
_C2_27 = 0.07407407407407407407
_PI4_3 = 4.18879020478639098458
_PISQ = 9.86960440108935861869
_TPISQ = 19.73920880217871723738
_HPISQ = 4.93480220054467930934

def _maxr():
    """Load-time probe ``lens_forward(latlon_to_ray(0, pi))``
    (vandergrinten.lua:108): the ray passes through the float32 C builtin,
    lat resolves to exactly 0 (equator branch) and the result is the
    float32-roundtripped longitude."""
    from blinky_tpu_torch.geometry import latlon_to_ray_f32, ray_to_latlon

    _, lon = ray_to_latlon(*latlon_to_ray_f32(0.0, math.pi))
    return float(lon)


_MAXR = _maxr()


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        # Pole branch (|lat| == pi/2): x = 0, y = +-pi*tan(t/2).
        t_pole = m.asin(m.abs(2 * lat / m.pi))
        y_pole = m.pi * m.tan(t_pole / 2)
        y_pole = m.where(y_pole * lat < 0, -y_pole, y_pole)
        # General branch.
        t = m.asin(m.abs(2 * lat / m.pi))
        a = 0.5 * m.abs(m.pi / lon - lon / m.pi)
        g = m.cos(t) / (m.sin(t) + m.cos(t) - 1)
        p = g * (2 / m.sin(t) - 1)
        q = a * a + g
        gp = g - p * p
        px = m.pi * (a * gp + m.sqrt(a * a * gp * gp - (p * p + a * a) * (g * g - p * p))) / (p * p + a * a)
        py = m.pi * (p * q - a * m.sqrt((a * a + 1) * (p * p + a * a) - q * q)) / (p * p + a * a)
        px = m.where(lon * px < 0, -px, px)
        py = m.where(lat * py < 0, -py, py)
        eq = lat == 0
        pole = m.abs(lat) == m.pi / 2
        out_x = m.where(eq, lon, m.where(pole, 0.0, px))
        out_y = m.where(eq, 0.0, m.where(pole, y_pole, py))
        return out_x, out_y, True

    def lens_inverse(x, y):
        x2 = x * x
        ay = m.abs(y)

        # Branch 1: ay < TOL — on the equator axis (vandergrinten.lua:55-66).
        t_eq = x2 * x2 + _TPISQ * (x2 + _HPISQ)
        lon_eq = m.where(m.abs(x) <= _TOL, 0.0, 0.5 * (x2 - _PISQ + m.sqrt(t_eq)) / x_safe(x))
        lat_eq = x * 0.0

        # Branch 2: general cubic resolvent (vandergrinten.lua:68-105).
        y2 = y * y
        r = x2 + y2
        r2 = r * r
        c1 = -m.pi * ay * (r + _PISQ)
        c3 = r2 + (2 * m.pi) * (ay * r + m.pi * (y2 + m.pi * (ay + m.pi / 2)))
        c2 = c1 + _PISQ * (r - 3 * y2)
        c0 = m.pi * ay
        c2 = c2 / c3
        al = c1 / c3 - _THIRD * c2 * c2
        mm = 2 * m.sqrt(-_THIRD * al)
        d = _C2_27 * c2 * c2 * c2 + (c0 * c0 - _THIRD * c2 * c1) / c3
        d = 3 * d / (al * mm)
        t = m.abs(d)
        solvable = (t - _TOL) <= 1
        d_clamped = m.where(t > 1, m.where(d > 0, 0.0, m.pi), m.acos(m.minimum(m.maximum(d, -1.0), 1.0)))
        lat_g = m.pi * (mm * m.cos(d_clamped * _THIRD + _PI4_3) - _THIRD * c2)
        lat_g = m.where(y < 0, -lat_g, lat_g)
        t2 = r2 + _TPISQ * (x2 - y2 + _HPISQ)
        lon_g = m.where(
            m.abs(x) <= _TOL,
            0.0,
            m.where(
                t2 <= 0,
                0.5 * (r - _PISQ) / x_safe(x),
                0.5 * (r - _PISQ + m.sqrt(m.maximum(t2, 0.0))) / x_safe(x),
            ),
        )

        on_axis = ay < _TOL
        lat = m.where(on_axis, lat_eq, lat_g)
        lon = m.where(on_axis, lon_eq, lon_g)
        valid = ~(x2 + y * y > _MAXR * _MAXR) & (on_axis | solvable)
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=2 * _MAXR,
        lens_height=2 * _MAXR,
        onload="f_contain",
    )


def x_safe(x):
    """Divide-by-x guard: callers only use the quotient where |x| > TOL."""
    return m.where(m.abs(x) <= _TOL, 1.0, x)
