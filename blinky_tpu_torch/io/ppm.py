"""Minimal binary PPM (P6) writer/reader for RGB export.

The reference's only image export is 8-bit PCX with a palette trailer
(``WritePCXfile``, ``common/screen.c:681``); PPM is this framework's
dependency-free RGB container for the video-export pipeline (every image
tool reads it).
"""

from __future__ import annotations

import numpy as np


def encode_ppm(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> binary P6 bytes."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError("encode_ppm expects [H, W, 3]")
    return b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes()


def decode_ppm(data: bytes) -> np.ndarray:
    """Binary P6 bytes -> [H, W, 3] uint8."""
    if not data.startswith(b"P6"):
        raise ValueError("not a binary PPM (P6)")
    # header: magic, width, height, maxval — whitespace/comment separated
    fields: list = []
    i = 2
    while len(fields) < 3:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        fields.append(int(data[i:j]))
        i = j
    i += 1  # single whitespace after maxval
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError("only 8-bit PPM supported")
    arr = np.frombuffer(data, dtype=np.uint8, count=h * w * 3, offset=i)
    return arr.reshape(h, w, 3).copy()
