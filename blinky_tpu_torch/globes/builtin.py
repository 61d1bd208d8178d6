"""The six built-in globes, re-derived from ``game/lua-scripts/globes/``.

Each is a fresh derivation of the same plate layouts (not a code port):
axis-aligned cube, the two rotated cubes, the triangular prism, the
tetrahedron with geometry-derived fov, and the two-plate ``fast`` globe with
its custom plate resolver.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.globes import make_globe, register

_CUBE_PLATES = [
    ((0, 0, 1), (0, 1, 0), 90),  # front
    ((1, 0, 0), (0, 1, 0), 90),  # right
    ((-1, 0, 0), (0, 1, 0), 90),  # left
    ((0, 0, -1), (0, 1, 0), 90),  # back
    ((0, 1, 0), (0, 0, -1), 90),  # top
    ((0, -1, 0), (0, 0, 1), 90),  # bottom
]


def _rot_xz(v, a):
    """Yaw rotation in the XZ plane as in ``cube_edge.lua:20-24``."""
    x, y, z = v
    return (x * math.cos(a) - z * math.sin(a), y, x * math.sin(a) + z * math.cos(a))


def _rot_yz(v, a):
    """Pitch rotation in the YZ plane as in ``cube_corner.lua:25-28``."""
    x, y, z = v
    return (x, y * math.cos(a) - z * math.sin(a), y * math.sin(a) + z * math.cos(a))


def cube():
    """Standard axis-aligned cubemap (``globes/cube.lua``), the default globe
    (``fisheye.c:669``)."""
    return make_globe("cube", _CUBE_PLATES)


def cube_edge():
    """Cube yawed 45° so an edge faces forward (``globes/cube_edge.lua``)."""
    a = math.pi / 4
    plates = [(_rot_xz(f, a), _rot_xz(u, a), fov) for f, u, fov in _CUBE_PLATES]
    return make_globe("cube_edge", plates)


def cube_corner():
    """Cube rotated 45° in yaw then pitch so a corner faces forward
    (``globes/cube_corner.lua``)."""
    a = math.pi / 4
    plates = [
        (_rot_yz(_rot_xz(f, a), a), _rot_yz(_rot_xz(u, a), a), fov)
        for f, u, fov in _CUBE_PLATES
    ]
    return make_globe("cube_corner", plates)


def trism():
    """Triangular prism: 3 x 120° ring + 2 x 128° caps (``globes/trism.lua``)."""
    c6, s6 = math.cos(math.pi / 6), math.sin(math.pi / 6)
    plates = [
        ((-c6, 0, s6), (0, 1, 0), 120),  # left
        ((c6, 0, s6), (0, 1, 0), 120),  # right
        ((0, 0, -1), (0, 1, 0), 120),  # back
        ((0, 1, 0), (0, 0, -1), 128),  # top
        ((0, -1, 0), (0, 0, -1), 128),  # bottom
    ]
    return make_globe("trism", plates)


def tetra():
    """Tetrahedron with fov computed from its geometry
    (``globes/tetra.lua:1-41``); plate vectors are intentionally left
    unnormalized exactly as the script computes them."""
    d120 = 2 * math.pi / 3
    d60 = d120 / 2
    r = 1.0  # face center to vertex
    s = 2 * r * math.sin(d60)  # side length
    h = math.sqrt(s * s - r * r)  # face to opposite vertex
    theta = math.acos(r / s)
    c = s / 2 / math.sin(theta)  # center to vertex
    e = r * math.cos(d60)  # face center to edge
    f = h - c  # center to face
    fovr = 2 * math.atan(r / f)
    fovd = fovr * 180 / math.pi + 1  # +1 closes the center hole (tetra.lua:19)

    y = e - e * e / (r + e)
    z = -f + h * e / (r + e)

    def ring(a):
        return (
            (y / f * math.sin(a), -y / f * math.cos(a), z / f),
            ((e - y) / e * math.sin(a), -(e - y) / e * math.cos(a), (-f - z) / e),
            fovd,
        )

    plates = [ring(0.0), ring(d120), ring(-d120), ((0, 0, -1), (0, -1, 0), fovd)]
    return make_globe("tetra", plates)


_FAST_BIG_FOV = 160.0


def fast_resolver_consts():
    """(dist, half window) of ``globes/fast.lua:10-27`` in double: the wide
    plate's pinhole distance and half the sharp plate's window on it."""
    dist = 0.5 / math.tan(_FAST_BIG_FOV * math.pi / 180 / 2)
    size = 2 * dist * math.tan(math.pi / 4)
    return dist, size / 2


def _fast_resolver(x, y, z, globe):
    """``globe_plate`` of ``globes/fast.lua:10-27``: rays in the central
    window of the sharp 90° plate resolve to plate 0, the rest of the front
    hemisphere to the wide plate 1, and the back hemisphere to none (-1)."""
    xp_ = m.xp(x, y, z)
    dist, half = fast_resolver_consts()
    u = m.safe_div(x, z) * dist
    v = m.safe_div(y, z) * dist
    small = (m.abs(u) < half) & (m.abs(v) < half)
    plate = xp_.where(small, 0, 1).astype(xp_.int32)
    return xp_.where(z <= 0, np.int32(-1), plate)


def fast_resolver_torch(x, y, z):
    """:func:`_fast_resolver` on float32 tensors, evaluated as the JAX
    package's float32 builder evaluates it: the double constants round to
    float32 (a Python scalar is weakly typed there), each operation rounds
    on its own.  Returns int32 plates, -1 for none."""
    dist, half = (float(np.float32(c)) for c in fast_resolver_consts())
    zero = z == 0
    den = torch.where(zero, 1.0, z)
    u = torch.where(zero, 0.0, x / den) * dist
    v = torch.where(zero, 0.0, y / den) * dist
    small = (u.abs() < half) & (v.abs() < half)
    plate = torch.where(small, 0, 1).to(torch.int32)
    return torch.where(z <= 0, -1, plate).to(torch.int32)


# globe resolvers the float32 torch builder has a twin for
TORCH_RESOLVERS = {_fast_resolver: fast_resolver_torch}


def fast():
    """Two overlaid forward plates (90° sharp center + 160° wide) with the
    custom resolver (``globes/fast.lua``)."""
    plates = [
        ((0, 0, 1), (0, 1, 0), 90),
        ((0, 0, 1), (0, 1, 0), _FAST_BIG_FOV),
    ]
    return make_globe("fast", plates, plate_resolver=_fast_resolver)


for _f in (cube, cube_edge, cube_corner, trism, tetra, fast):
    register(_f.__name__, _f)
