"""Winkel tripel projection.

Reference: ``game/lua-scripts/lenses/winkeltripel.lua`` — forward map with
standard parallel at acos(2/pi); inverse is a 25-iteration 2-D Newton solve
(ported in the reference from d3-geo-projection's winkel3 inverse) with a
per-element early break at eps = 1e-4, plus the script's manual corner
artifact mask (``winkeltripel.lua:95-102``) and the lon = pi envelope test.
"""

import math

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.geometry import latlon_to_ray, latlon_to_ray_f32, ray_to_latlon

_CLAT0 = 2 / math.pi  # cos of the standard parallel
_EPS = 0.0001


def _fwd_via_ray(lat, lon):
    """``lens_forward(latlon_to_ray(lat, lon))`` as the Lua executes it:
    the ray passes through the float32 C builtin, so the lat/lon the
    forward map sees are the float32-ray roundtrip, not the originals."""
    rx, ry, rz = latlon_to_ray_f32(lat, lon)
    lat2, lon2 = ray_to_latlon(rx, ry, rz)
    return _forward_latlon(lat2, lon2)


def _forward_latlon(lat, lon):
    clat = m.cos(lat)
    temp = clat * m.cos(lon * 0.5)
    d = m.acos(temp)
    c = 1 - temp * temp
    t = d / m.sqrt(c)
    px = 0.5 * (2 * t * clat * m.sin(lon * 0.5) + lon * _CLAT0)
    py = 0.5 * (t * m.sin(lat) + lat)
    return px, py


def make(ctx):
    def lens_forward(x, y, z):
        lat, lon = ray_to_latlon(x, y, z)
        px, py = _forward_latlon(lat, lon)
        return px, py, True

    # Load-time bound probes (winkeltripel.lua:85-89), through the f32 ray.
    _, hy = _fwd_via_ray(math.pi / 2, 0.0)
    wx, _ = _fwd_via_ray(0.0, math.pi)
    lens_height = 2 * float(hy)
    lens_width = 2 * float(wx)
    artifact_x = lens_width / 2 * 0.71
    artifact_y = lens_height / 2 * 0.81

    def _newton(x, y):
        halfpi = m.pi / 2

        # the targets (x, y) ride in the state so the NumPy active-set
        # path can compact them together with (lam, phi)
        def body(state):
            lam, phi, x, y = state
            cosphi = m.cos(phi)
            sinphi = m.sin(phi)
            sin_2phi = m.sin(2 * phi)
            sin2phi = sinphi * sinphi
            cos2phi = cosphi * cosphi
            sinlambda = m.sin(lam)
            coslambda_2 = m.cos(lam / 2)
            sinlambda_2 = m.sin(lam / 2)
            sin2lambda_2 = sinlambda_2 * sinlambda_2
            c = 1 - cos2phi * coslambda_2 * coslambda_2
            nz = c != 0
            f = m.where(nz, 1 / m.where(nz, c, 1.0), 0.0)
            e = m.where(nz, m.acos(cosphi * coslambda_2) * m.sqrt(f), 0.0)
            fx = 0.5 * (2 * e * cosphi * sinlambda_2 + lam / halfpi) - x
            fy = 0.5 * (e * sinphi + phi) - y
            dxdl = 0.5 * f * (cos2phi * sin2lambda_2 + e * cosphi * coslambda_2 * sin2phi) + 0.5 / halfpi
            dxdp = f * (sinlambda * sin_2phi / 4 - e * sinphi * sinlambda_2)
            dydl = 0.125 * f * (sin_2phi * sinlambda_2 - e * sinphi * cos2phi * sinlambda)
            dydp = 0.5 * f * (sin2phi * coslambda_2 + e * sin2lambda_2 * cosphi) + 0.5
            den = dxdp * dydl - dydp * dxdl
            siglam = (fy * dxdp - fx * dydp) / den
            sigphi = (fx * dydl - fy * dxdl) / den
            exit_ = (m.abs(siglam) < _EPS) & (m.abs(sigphi) < _EPS)
            return (lam - siglam, phi - sigphi, x, y), exit_

        lam, phi, _, _ = m.repeat_until(body, (x, y, x, y), max_iter=25)
        return lam, phi

    def lens_inverse(x, y):
        outside = m.abs(y) >= lens_height / 2
        artifact = (m.abs(x) > artifact_x) & (m.abs(y) > artifact_y)
        lon, lat = _newton(x, y)
        # Envelope test (winkeltripel.lua:80-84): compare |x| against the
        # forward image of (lat, pi) — through the f32 ray roundtrip.
        x0, _ = _fwd_via_ray(lat, lat * 0 + m.pi)
        inside = m.abs(x) < m.abs(x0)
        valid = ~outside & ~artifact & inside
        vx, vy, vz = latlon_to_ray(lat, lon)
        return vx, vy, vz, valid

    return dict(
        lens_inverse=lens_inverse,
        lens_forward=lens_forward,
        max_fov=360,
        max_vfov=180,
        lens_width=lens_width,
        lens_height=lens_height,
        onload="f_contain",
    )
