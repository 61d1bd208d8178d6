"""Spherical / plate-frame geometry.

Transcribes the pure coordinate converters of the reference
(``engine/NQ/fisheye.c:1184-1214`` and ``fisheye.c:2023-2066``) as
vectorized, dtype-generic array functions, as in :mod:`blinky_tpu.geometry`.
Rays are passed as component triples ``(x, y, z)`` so the same code
broadcasts over pixel grids, on NumPy float64 for the exact host builder and
on torch tensors for the float32 device builder.

Coordinate system (camera frame; reference header comment ``fisheye.c:48-60``):
``+X`` right, ``+Y`` up, ``+Z`` forward.  Latitude is degrees-up toward +Y,
longitude degrees-right toward +X.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch import xmath as m


def latlon_to_ray(lat, lon):
    """Spherical (radians) -> unit direction. Reference: ``fisheye.c:1184-1190``."""
    clat = m.cos(lat)
    return m.sin(lon) * clat, m.sin(lat), m.cos(lon) * clat


def ray_to_latlon(x, y, z):
    """Direction -> spherical (radians). Reference: ``fisheye.c:1192-1196``.

    Lens scripts only ever reach this through the Lua builtin
    ``CtoLUA_ray_to_latlon`` (``fisheye.c:1506-1519``), which passes the
    components through a ``vec3_t``: the inputs truncate to float32 and
    the sum of squares under the sqrt evaluates in float32 (``vec_t``
    arithmetic) before the double ``sqrt``/``atan2``.
    """
    if m.xp(x, y, z) is torch:
        # the float32 builder: the inputs are float32 already
        lon = m.atan2(x, z)
        lat = m.atan2(y, m.sqrt(x * x + z * z))
        return lat, lon
    x32 = np.asarray(x, dtype=np.float32)
    y32 = np.asarray(y, dtype=np.float32)
    z32 = np.asarray(z, dtype=np.float32)
    sumsq = (x32 * x32 + z32 * z32).astype(np.float64)
    lon = m.atan2(x32.astype(np.float64), z32.astype(np.float64))
    lat = m.atan2(y32.astype(np.float64), m.sqrt(sumsq))
    return lat, lon


def normalize(x, y, z):
    """Normalize a ray, leaving zero-length rays untouched.

    Mirrors ``VectorNormalize`` (``engine/common/mathlib.c:413-429``): the
    zero-length branch returns the vector unchanged.
    """
    length = m.sqrt(x * x + y * y + z * z)
    inv = m.where(length != 0, 1.0 / m.where(length != 0, length, 1.0), 1.0)
    return x * inv, y * inv, z * inv


def plate_uv_to_ray(u, v, p_forward, p_right, p_up, p_dist):
    """Plate texture uv -> unit ray.

    Reference ``fisheye.c:1198-1214``: recenters uv, flips v, combines the
    **stored** plate dist with the frame vectors, then normalizes.

    Args:
        u, v: [...] in [0, 1].
        p_forward, p_right, p_up: [..., 3] plate frames (broadcast or
            pre-gathered).
        p_dist: [...] plate plane distances.
    Returns:
        (x, y, z) unit ray components.
    """
    uu = u - 0.5
    vv = -(v - 0.5)
    x = p_dist * p_forward[..., 0] + uu * p_right[..., 0] + vv * p_up[..., 0]
    y = p_dist * p_forward[..., 1] + uu * p_right[..., 1] + vv * p_up[..., 1]
    z = p_dist * p_forward[..., 2] + uu * p_right[..., 2] + vv * p_up[..., 2]
    return normalize(x, y, z)


def plate_frames(forward, up):
    """Re-orthogonalize plate bases exactly as the globe loader does.

    ``right = up x forward; up = forward x right`` with **no** normalization
    (``fisheye.c:1849-1850``).  The C stores plate vectors as ``vec_t`` =
    **float32** (``fisheye.c:354-356``) and the cross products run in
    float arithmetic, so the inputs are truncated to float32 and the math
    stays float32.

    Args:
        forward, up: arrays [..., 3].
    Returns:
        (forward, right, up) float32 arrays [..., 3].
    """
    forward = np.asarray(forward, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    right = np.cross(up, forward).astype(np.float32)
    up2 = np.cross(forward, right).astype(np.float32)
    return forward, right, up2


def latlon_to_ray_f32(lat, lon):
    """``latlon_to_ray`` as the Lua scripts see it through the C builtin
    (``CtoLUA_latlon_to_ray``, ``fisheye.c:1494-1505``): the double math
    passes through a ``vec3_t`` (float32) before reaching Lua.  Returns the
    float32-truncated components as float64 values."""
    x, y, z = latlon_to_ray(lat, lon)
    if m.xp(lat, lon) is torch:
        return tuple(c.to(torch.float32).to(c.dtype) for c in (x, y, z))
    return (
        np.float64(np.float32(x)),
        np.float64(np.float32(y)),
        np.float64(np.float32(z)),
    )


# ---------------------------------------------------------------------------
# C mixed-precision emulation (vec_t = float32, lens math = double).
# ---------------------------------------------------------------------------


def normalize_c(x, y, z, xp, f32, f64):
    """``VectorNormalize`` (``engine/common/mathlib.c:412-429``) on float32
    components: float32 sum of squares, ``sqrt`` computed in double and
    truncated back to float32 (C calls the double ``sqrt`` on a float),
    float32 reciprocal, float32 multiplies.  Zero length leaves the vector
    unchanged (NaN lengths proceed — NaN is truthy in ``if (length)``).
    On tensors *xp* is ``torch`` and *f32*, *f64* are torch dtypes; the
    square root is taken in float64 for either *f64*, which rounds as a
    correctly rounded float32 square root does (53 >= 2 * 24 + 2 bits), on
    every device: the CPU's vectorised float32 ``torch.sqrt`` is an ulp off
    on some inputs, the card's is correctly rounded."""
    if xp is torch:
        x, y, z = x.to(f32), y.to(f32), z.to(f32)
        sumsq = x * x + y * y + z * z  # f32, left-to-right
        length = torch.sqrt(sumsq.to(torch.float64)).to(f32)
        nonzero = length != 0
        one = torch.ones_like(length)
        inv = torch.where(nonzero, one / torch.where(nonzero, length, one), one)
        return x * inv, y * inv, z * inv
    x = x.astype(f32)
    y = y.astype(f32)
    z = z.astype(f32)
    sumsq = x * x + y * y + z * z  # f32, left-to-right
    length = xp.sqrt(sumsq.astype(f64)).astype(f32)
    nonzero = length != 0
    inv = xp.where(nonzero, (f32(1.0) / xp.where(nonzero, length, f32(1.0))), f32(1.0))
    return x * inv, y * inv, z * inv


def ray_to_plate_index_c(x32, y32, z32, plate_forward32, xp):
    """``ray_to_plate_index`` (``fisheye.c:2023-2050``) with the C types:
    ``DotProduct`` of two float32 vectors evaluates in float32, the result
    is compared in double; strict ``>`` keeps the first maximum."""
    # contiguous column copies: broadcasting a strided [n] view against a
    # [H, W, 1] operand defeats NumPy's SIMD loops
    f0, f1, f2 = (xp.asarray(plate_forward32[:, i]).copy() for i in range(3))
    dots = (
        x32[..., None] * f0 + y32[..., None] * f1 + z32[..., None] * f2
    )  # f32 arithmetic; comparisons identical in f32 or promoted f64
    return xp.argmax(dots, axis=-1).astype(xp.int32)


def ray_to_plate_uv_c(x32, y32, z32, p_forward32, p_right32, p_up32, p_fov32, f64):
    """``ray_to_plate_uv`` (``fisheye.c:2052-2066``) with the C types:
    float32 dot products promoted to double, ``dist`` recomputed in double
    from the float32-stored fov, u/v in double, closed-interval bounds.
    NumPy arrays; *f64* is ``np.float64``."""
    rx = (p_right32[..., 0] * x32 + p_right32[..., 1] * y32 + p_right32[..., 2] * z32).astype(f64)
    ry = (p_up32[..., 0] * x32 + p_up32[..., 1] * y32 + p_up32[..., 2] * z32).astype(f64)
    rz = (p_forward32[..., 0] * x32 + p_forward32[..., 1] * y32
          + p_forward32[..., 2] * z32).astype(f64)
    dist = 0.5 / m.tan(p_fov32.astype(f64) / 2)
    u = m.safe_div(rx, rz) * dist + 0.5
    v = m.safe_div(-ry, rz) * dist + 0.5
    valid = (rz != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return u, v, valid


def plate_uv_to_ray_c(u, v, forward32, right32, up32, dist32, xp, f32, f64):
    """``plate_uv_to_ray`` (``fisheye.c:1198-1214``) with the C types:
    u/v computed in double, then truncated to float32 at each ``VectorMA``
    call (``mathlib.c:349-355`` is a float function), then the float32
    ``VectorNormalize``.  On tensors *xp* is ``torch``, *f32* and *f64* are
    torch dtypes and the plate vectors are tensors."""
    if xp is torch:
        u32 = torch.as_tensor(u - 0.5).to(f32)
        v32 = (-(torch.as_tensor(v) - 0.5)).to(f32)
        rx, ry, rz = (dist32 * forward32[..., i] + u32 * right32[..., i]
                      + v32 * up32[..., i] for i in range(3))
        return normalize_c(rx, ry, rz, xp, f32, f64)
    u32 = xp.asarray(u - 0.5).astype(f32)
    v32 = xp.asarray(-(xp.asarray(v) - 0.5)).astype(f32)
    rx = dist32 * forward32[..., 0]
    ry = dist32 * forward32[..., 1]
    rz = dist32 * forward32[..., 2]
    rx = rx + u32 * right32[..., 0]
    ry = ry + u32 * right32[..., 1]
    rz = rz + u32 * right32[..., 2]
    rx = rx + v32 * up32[..., 0]
    ry = ry + v32 * up32[..., 1]
    rz = rz + v32 * up32[..., 2]
    return normalize_c(rx, ry, rz, xp, f32, f64)


def ray_to_plate_index(x, y, z, plate_forward):
    """Closest plate by maximum dot product, first index wins ties
    (``fisheye.c:2023-2050`` scans with a strict ``>``; ``argmax`` keeps the
    first maximum).  *x, y, z*: ray components of any broadcastable shape,
    arrays or tensors; *plate_forward*: [n, 3].  Returns int32 [...]."""
    if m.xp(x, y, z) is torch:
        f = torch.as_tensor(np.asarray(plate_forward), device=x.device)
        dots = x[..., None] * f[:, 0] + y[..., None] * f[:, 1] + z[..., None] * f[:, 2]
        return torch.argmax(dots, dim=-1).to(torch.int32)
    f0, f1, f2 = (np.asarray(plate_forward[:, i]).copy() for i in range(3))
    dots = x[..., None] * f0 + y[..., None] * f1 + z[..., None] * f2
    return np.argmax(dots, axis=-1).astype(np.int32)


def ray_to_plate_uv(x, y, z, p_forward, p_right, p_up, p_fov_rad):
    """Project a ray onto one plate's image plane (``fisheye.c:2052-2066``):
    dot the ray with the plate frame, recompute ``dist = 0.5/tan(fov/2)``,
    then ``u = x/z*dist + 0.5``, ``v = -y/z*dist + 0.5``; valid iff both lie
    in the closed interval [0, 1].

    ``p_forward, p_right, p_up``: per-element plate frames [..., 3];
    ``p_fov_rad``: per-element plate fov [...].  Returns (u, v, valid).
    """
    rx = p_right[..., 0] * x + p_right[..., 1] * y + p_right[..., 2] * z
    ry = p_up[..., 0] * x + p_up[..., 1] * y + p_up[..., 2] * z
    rz = p_forward[..., 0] * x + p_forward[..., 1] * y + p_forward[..., 2] * z
    dist = 0.5 / m.tan(p_fov_rad / 2)
    u = m.safe_div(rx, rz) * dist + 0.5
    v = m.safe_div(-ry, rz) * dist + 0.5
    valid = (rz != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    return u, v, valid


def plate_dist(fov_rad):
    """Pinhole plane distance for a plate fov: ``0.5 / tan(fov/2)``
    (``fisheye.c:1868``)."""
    return 0.5 / m.tan(fov_rad / 2)
