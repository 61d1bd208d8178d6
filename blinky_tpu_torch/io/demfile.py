"""Quake ``.dem`` demo files: the reference engine's own recording format.

The reference records demos as the raw server-message stream prefixed
per message with the client's view angles (``CL_WriteDemoMessage``,
``engine/NQ/cl_demo.c:77-92``): a header line with the forced CD track
(ASCII integer + ``'\\n'``, ``cl_demo.c:259-260``), then blocks of

    int32   message length (little-endian, <= MAX_MSGLEN = 32768)
    float32 viewangles[3]  (pitch, yaw, roll; little-endian)
    bytes   message data

(``CL_GetMessage`` read loop, ``cl_demo.c:124-137``).  This module reads
that format directly, so the camera track of a real engine recording can
drive :meth:`blinky_tpu_torch.api.Session.render_posed` / ``reproject
--follow-poses`` without any intermediate text export — together with
per-frame ``f_saveglobe`` dumps it closes the loop from the reference's
own artifacts to the batch pipeline.

During playback the engine interpolates frames *between* messages with a
shortest-arc per-component lerp (``CL_RelinkEntities``,
``engine/NQ/cl_main.c:567-576``); :func:`lerp_pose_track` reproduces that
so a message-rate track can be resampled to frame rate.

Only the angle track and message sizes are decoded — the message bodies
are game-protocol state (simulation is out of scope per SURVEY.md §2),
but their sizes are kept for diagnostics and faithful round-trips.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: max length of a reliable message, engine/NQ/quakedef.h:66
MAX_MSGLEN = 32768


@dataclass
class DemFile:
    """Decoded ``.dem`` contents (angle track; message bodies optional)."""

    cdtrack: int
    poses: np.ndarray  # [N, 3] float32 — (pitch, yaw, roll) per message
    message_sizes: np.ndarray  # [N] int32
    messages: list | None = None  # list of bytes when keep_messages=True

    def __len__(self) -> int:
        return len(self.poses)


def read_dem(src, keep_messages: bool = False) -> DemFile:
    """Read a ``.dem`` file (path or bytes) into a :class:`DemFile`.

    Header and block parsing follow ``CL_PlayDemo_f`` /
    ``CL_GetMessage`` exactly: the CD-track line must contain a
    ``'\\n'`` within the first 12 characters, characters are masked
    ``& 127``, and the track parses as a decimal integer
    (``cl_demo.c:315-333``); each block is ``<i32 len><3 f32 angles>``
    + ``len`` message bytes, with ``len > MAX_MSGLEN`` an error and a
    short trailing block ending playback (``cl_demo.c:124-141``).
    """
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
        name = "<bytes>"
    else:
        data = Path(src).read_bytes()
        name = str(src)

    # --- header: CD track line (cl_demo.c:315-333) ---
    # The engine tests the UNMASKED byte for '\n' but stores each char
    # masked & 127, then parses with sscanf("%d") — a PREFIX parse that
    # skips leading whitespace and ignores trailing junk.
    nl = data[:12].find(b"\n")
    if nl < 0:
        raise ValueError(f"demo {name!r} is invalid (no newline in header)")
    header = bytes(c & 127 for c in data[:nl])
    m = re.match(rb"\s*[+-]?\d+", header)
    if m is None:
        raise ValueError(f"invalid cd track {header!r} in demo {name}")
    cdtrack = int(m.group())

    # --- message blocks ---
    off = nl + 1
    poses: list[tuple] = []
    sizes: list[int] = []
    messages: list[bytes] | None = [] if keep_messages else None
    n = len(data)
    while off + 16 <= n:
        (length,) = struct.unpack_from("<i", data, off)
        if length > MAX_MSGLEN:
            raise ValueError(
                f"demo message > MAX_MSGLEN ({length} > {MAX_MSGLEN})"
            )
        if length < 0 or off + 16 + length > n:
            break  # truncated final block: engine stops playback here
        poses.append(struct.unpack_from("<3f", data, off + 4))
        sizes.append(length)
        if messages is not None:
            messages.append(data[off + 16 : off + 16 + length])
        off += 16 + length

    return DemFile(
        cdtrack=cdtrack,
        poses=np.asarray(poses, dtype=np.float32).reshape(-1, 3),
        message_sizes=np.asarray(sizes, dtype=np.int32),
        messages=messages,
    )


def write_dem(path, poses, messages=None, cdtrack: int = -1) -> None:
    """Write a ``.dem`` file in the engine's recording format.

    Mirrors ``CL_Record_f`` + ``CL_WriteDemoMessage``
    (``cl_demo.c:259-260, 77-92``): CD-track header line, then one
    ``<i32 len><3 f32 angles><message>`` block per pose.  ``messages``
    defaults to a single ``svc_nop`` byte per block
    (``NQ/protocol.h:191``) so the engine's reader (which treats a
    zero-length body read as end-of-demo) accepts the file.
    """
    poses = np.asarray(poses, dtype=np.float32).reshape(-1, 3)
    if messages is None:
        messages = [b"\x01"] * len(poses)  # svc_nop
    if len(messages) != len(poses):
        raise ValueError(
            f"{len(messages)} messages for {len(poses)} poses"
        )
    out = bytearray(f"{int(cdtrack)}\n".encode("ascii"))
    for (pitch, yaw, roll), msg in zip(poses, messages):
        if len(msg) > MAX_MSGLEN:
            raise ValueError(f"demo message > MAX_MSGLEN ({len(msg)})")
        out += struct.pack("<i3f", len(msg), pitch, yaw, roll)
        out += bytes(msg)
    Path(path).write_bytes(bytes(out))


def lerp_pose_track(poses, n_out: int) -> np.ndarray:
    """Resample a message-rate angle track to ``n_out`` frames with the
    engine's demo-playback interpolation: per-component shortest-arc
    lerp, wrapping deltas into [-180, 180) (``CL_RelinkEntities``,
    ``engine/NQ/cl_main.c:567-576``; ``d >= 180 → d -= 360``,
    ``d < -180 → d += 360``).

    Frame ``k`` samples the track at ``t = k * (N-1) / (n_out-1)``
    (endpoints preserved).  Angles are NOT re-wrapped after the lerp,
    matching the engine (``cl.viewangles`` may leave [0, 360)).
    """
    poses = np.asarray(poses, dtype=np.float32).reshape(-1, 3)
    if len(poses) == 0:
        raise ValueError("empty pose track")
    if len(poses) == 1 or n_out == 1:
        return np.repeat(poses[:1], n_out, axis=0)
    t = np.linspace(0.0, len(poses) - 1.0, n_out)
    i0 = np.minimum(t.astype(np.int64), len(poses) - 2)
    frac = (t - i0)[:, None].astype(np.float32)
    a, b = poses[i0], poses[i0 + 1]
    d = b - a
    d = np.where(d >= 180.0, d - 360.0, d)
    d = np.where(d < -180.0, d + 360.0, d)
    return (a + frac * d).astype(np.float32)
