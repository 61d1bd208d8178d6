"""Peirce quincuncial: the full sphere in a tileable square.

Reference: ``game/lua-scripts/lenses/quincuncial.lua`` — a Lua port of the
Jacobi elliptic function ``ellipj`` (itself from d3-geo-projection /
Matlab) plus ``cnrectify`` from Fong & Vogel, "Warping Peirce Quincuncial
Panoramas" (arXiv:1011.3189), with a 5-region square rotation
(``quincuncial.lua:170-201``).

The reference's AGM loop in ``ellipj`` iterates until ``|c[i]/a[i]| <=
eps``; for the fixed modulus m = 1/2 used by this lens the AGM tables and
iteration count are data-independent, so they are precomputed at load time
and the per-pixel descending phi recurrence is a fixed-length loop.
"""

import math

import torch

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray

_EPS = 0.0001
_HALFPI = math.pi / 2
_SQRT2 = math.sqrt(2)
_SQRT22 = _SQRT2 / 2
_M = 0.5
_KE = 1.85407467730137


def _agm_tables(mval):
    """Static AGM sequence of ``ellipj`` (quincuncial.lua:37-50) for a fixed
    modulus: returns (a[], c[], twon) with the Lua loop's exact exit rule."""
    a = [1.0]
    c = [math.sqrt(mval)]
    b = math.sqrt(1 - mval)
    twon = 1.0
    while abs(c[-1] / a[-1]) > _EPS and len(a) < 9:
        ai = a[-1]
        c.append(0.5 * (ai - b))
        a.append(0.5 * (ai + b))
        b = math.sqrt(ai * b) if ai * b > 0 else 0.0  # asqrt
        twon *= 2
    return a, c, twon


_A, _C, _TWON = _agm_tables(_M)  # m = 1/2 and 1 - m = 1/2 share tables


def _ellipj(u):
    """Vectorized ``ellipj(u, 1/2)`` (quincuncial.lua:52-66): descending
    Landen/phi recurrence over the static AGM tables.
    Returns (sn, cn, dn, ph).

    One loop for both array namespaces.  On NumPy (the float64 host build,
    glibc libm through xmath) it runs over the Python float constants; on
    tensors over the same constants, in the same order, as 0-d tensors of
    the input's dtype on its device, as the JAX package's ``lax.scan`` does:
    each float32 constant rounds as the scan's stacked constants do, and
    every division is a true division by a tensor."""
    n = len(_A)
    if m.xp(u) is m.np:
        const = float
    else:
        def const(v):
            return torch.tensor(v, dtype=u.dtype, device=u.device)

    phi = const(_TWON * _A[n - 1]) * u
    b = phi
    for k in range(n - 1, 0, -1):
        b = phi
        t = const(_C[k]) * m.sin(b) / const(_A[k])
        phi = 0.5 * (m.asin(t) + phi)
    t = m.cos(phi)
    return m.sin(phi), t, t / m.cos(phi - b), phi


def _cnrectify(x, y):
    """Square -> spherical coordinates (quincuncial.lua:79-108)."""
    xpr = _KE * (_SQRT22 * x - _SQRT22 * y) / _SQRT2 + _KE
    ypr = _KE * (_SQRT22 * x + _SQRT22 * y) / _SQRT2
    s, c, d, _ = _ellipj(xpr)
    s1, c1, d1, _ = _ellipj(ypr)
    # Lua: c1^2 + m*s^2*s1^2 — ^ is pow() (== one-rounding square) and
    # the products associate (m*s^2)*s1^2; keep that exact order, a
    # different association drifts 1 ulp and flips texel boundaries at
    # production sizes (the 1080p C-reference pin caught this)
    delta = c1 * c1 + _M * (s * s) * (s1 * s1)
    x1g = (c * c1) / delta
    y1g = -(s * d * s1 * d1) / delta
    near_axis = m.abs(ypr) < _EPS
    x1 = m.where(near_axis, c, x1g)
    y1 = m.where(near_axis, 0.0, y1g)
    longd = m.atan2(y1, x1)
    latp = 2 * m.atan2(m.sqrt(x1 * x1 + y1 * y1), 1 + 0 * x1) - _HALFPI
    return latp, longd


def _rotate(a, b, angle):
    c, s = math.cos(angle), math.sin(angle)
    return a * c - b * s, a * s + b * c


def make(ctx):
    def _intermediate(x0, y0):
        """quincuncial.lua:149-158: the unfolded 4x2 intermediate frame."""
        valid = ~((m.abs(x0) > 2) | (m.abs(y0) > 1))
        lat, lon = _cnrectify(x0 + 1, y0)
        rx, ry, rz = latlon_to_ray(lat, -lon)
        # rotate from south pole to origin (quincuncial.lua:156-157)
        return rx, rz, -ry, valid

    def lens_inverse(x, y):
        in_square = ~((m.abs(x) > _SQRT2) | (m.abs(y) > _SQRT2))
        r1x, r1y = _rotate(x, y, math.pi / 4)
        r2x, r2y = _rotate(x, y, math.pi / 4 + math.pi)

        front_or_lr = (m.abs(x) + m.abs(y) < _SQRT2) | ((x > 0) & (y < 0))
        ul = (x < 0) & (y > 0)
        ll = (x < 0) & (y < 0)

        x0 = m.where(front_or_lr, r1x - 1, m.where(ul, r1x + 3, r2x + 1))
        y0 = m.where(
            front_or_lr, r1y, m.where(ul, r1y, m.where(ll, r2y - 2, r2y + 2))
        )
        vx, vy, vz, inner_ok = _intermediate(x0, y0)
        return vx, vy, vz, in_square & inner_ok

    return dict(
        lens_inverse=lens_inverse,
        lens_width=2 * _SQRT2,
        lens_height=2 * _SQRT2,
        onload="f_contain",
    )
