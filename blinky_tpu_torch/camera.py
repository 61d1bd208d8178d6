"""Camera pose math: view angles -> basis.

The port of :mod:`blinky_tpu.camera`.  The reference
drives each plate render by composing the plate's camera-relative frame
with the player's view basis: ``AngleVectors(r_refdef.viewangles)``
(``engine/common/mathlib.c:311-341``) then ``plate (x) camera``
(``engine/NQ/fisheye.c:750,777-792``).  For recorded cubemaps the pose
composes into the lensmap instead (:mod:`blinky_tpu_torch.kernels.posed`).
"""

from __future__ import annotations

import numpy as np

from blinky_tpu_torch import xmath as m


def angle_vectors(pitch, yaw, roll):
    """Quake view angles (degrees) -> (forward, right, up) world basis.

    Transcribes ``AngleVectors`` (``engine/common/mathlib.c:311-341``)
    including its sign conventions.  Vectorized over leading dimensions;
    returns arrays [..., 3].
    """
    xp = m.xp(pitch, yaw, roll)
    d2r = m.pi / 180
    sy, cy = m.sin(yaw * d2r), m.cos(yaw * d2r)
    sp, cp = m.sin(pitch * d2r), m.cos(pitch * d2r)
    sr, cr = m.sin(roll * d2r), m.cos(roll * d2r)

    forward = xp.stack([cp * cy, cp * sy, -sp], axis=-1)
    right = xp.stack(
        [
            -sr * sp * cy + cr * sy,
            -sr * sp * sy - cr * cy,
            -sr * cp,
        ],
        axis=-1,
    )
    up = xp.stack(
        [
            cr * sp * cy + sr * sy,
            cr * sp * sy - sr * cy,
            cr * cp,
        ],
        axis=-1,
    )
    return forward, right, up


def view_basis_from_angles(pitch, yaw, roll):
    """(pitch, yaw, roll) degrees -> (forward, right, up) in the fisheye
    camera convention (+X right, +Y up, +Z forward; ``fisheye.c:48-60``).

    Positive yaw looks right (toward +X), positive pitch looks up (+Y), and
    positive roll tilts the up vector toward the right vector, the same
    roll sense as Quake's ``AngleVectors`` (``mathlib.c:311-341``).  The
    sines and cosines are NumPy's, as in :mod:`blinky_tpu.camera`, so the
    bases bit-equal the JAX package's on the same machine.
    """
    d2r = np.pi / 180
    sp, cp = np.sin(pitch * d2r), np.cos(pitch * d2r)
    sy, cy = np.sin(yaw * d2r), np.cos(yaw * d2r)
    sr, cr = np.sin(roll * d2r), np.cos(roll * d2r)
    forward = np.array([sy * cp, sp, cy * cp])
    right0 = np.array([cy, 0.0, -sy])
    up0 = np.cross(forward, right0)
    up0 /= np.linalg.norm(up0)
    right0 = np.cross(up0, forward)
    right = cr * right0 - sr * up0
    up = cr * up0 + sr * right0
    return forward, right, up


def plate_world_basis(globe, forward, right, up):
    """World-frame (forward, right, up) for every plate of *globe* given a
    camera basis: the per-plate composition in ``F_RenderView``
    (``fisheye.c:777-792``), each plate vector's components weighting the
    camera's (right, up, forward) axes.

    ``forward, right, up``: the camera basis, arrays [..., 3].  Returns
    (f, r, u), arrays [..., numplates, 3].
    """
    cam = np.stack([np.asarray(right), np.asarray(up), np.asarray(forward)], axis=-2)

    def mix(plate_vecs):  # [n, 3] x [..., 3, 3] -> [..., n, 3]
        return np.einsum("nc,...cw->...nw", plate_vecs, cam)

    return mix(globe.forward), mix(globe.right), mix(globe.up)
