"""The view angles of a recorded demo, frame by frame, and their camera
bases, made from ``--seed``: what a converter knows of the track before it
renders.

A NetQuake demo stores each frame's view angles: ``CL_GetMessage``
(TyrQuake ``engine/NQ/cl_demo.c``) reads three floats a message into
``cl.mviewangles[0]``, and the client clamps pitch to [-70, 80] and roll to
+-50 (``CL_AdjustAngles``, ``engine/NQ/cl_input.c``).  Both are cited from
what is known of TyrQuake's sources; neither file was at hand to check.
No recorded track ships with the benchmark, so each ring slot's track is
drawn uniformly from the configuration's ranges (pitch +-60, yaw 0-360,
roll +-30, inside those clamps), and the first slot starts with the
identity and (89, 180, 0), a view beside the pole.

The bases are written from the equations: Quake's ``AngleVectors``
(``engine/common/mathlib.c:311-341``) gives (forward, right, up) in the
world's axes (x ahead, y left, z up), with positive pitch looking down and
positive yaw turning left.  The camera frame of ``render_posed`` is the
fisheye's (``fisheye.c:48-60``: +X right, +Y up, +Z forward), with positive
pitch looking up and positive yaw turning right, as its docstring states.
So a basis is ``AngleVectors(-pitch, -yaw, roll)`` with each vector's
components (x, y, z) taken as (-y, z, x).  Nothing here imports the
program.
"""

from __future__ import annotations

import numpy as np

from benchmark import sources

FIRST = ((0.0, 0.0, 0.0), (89.0, 180.0, 0.0))  # the first slot's first poses


def tracks(seed: int, ring: int, batch: int, cfg: dict) -> list:
    """*ring* tracks of *batch* (pitch, yaw, roll) degrees, float64
    ``[batch, 3]``, drawn uniformly from ``cfg``'s ``pose_pitch``,
    ``pose_yaw`` and ``pose_roll`` ranges."""
    rng = np.random.default_rng(sources.stream_seed(seed, 3))
    out = []
    for _ in range(ring):
        t = np.stack([rng.uniform(*cfg[k], batch)
                      for k in ("pose_pitch", "pose_yaw", "pose_roll")], axis=1)
        out.append(t)
    n = min(len(FIRST), batch)
    out[0][:n] = FIRST[:n]
    return out


def bases(angles) -> np.ndarray:
    """``[B, 3]`` (pitch, yaw, roll) degrees -> ``[B, 3, 3]`` float64 bases,
    rows (forward, right, up) in the camera frame."""
    a = np.radians(np.asarray(angles, np.float64))
    sp, sy, sr = np.sin(a).T
    cp, cy, cr = np.cos(a).T
    forward = np.stack([sy * cp, sp, cy * cp], axis=-1)
    right = np.stack([cr * cy + sr * sp * sy, -sr * cp, sr * sp * cy - cr * sy], axis=-1)
    up = np.stack([sr * cy - cr * sp * sy, cr * cp, -(cr * sp * cy + sr * sy)], axis=-1)
    return np.stack([forward, right, up], axis=1)
