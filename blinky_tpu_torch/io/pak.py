"""Quake PAK archive reader (the asset-fixture harness).

The reference loads game assets through ``COM_FOpenFile``
(``engine/common/common.c:1553``), which searches id's PAK archives:
a 12-byte header (``"PACK"``, directory offset, directory length) and
64-byte directory entries (56-byte zero-padded name, offset, size) —
``engine/common/common.c`` ``dpackheader_t``/``dpackfile_t``.  This
reader is how the framework ingests real game data — most importantly
``gfx/palette.lmp`` — without the game engine.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<4sii")
_ENTRY = struct.Struct("<56sii")


def read_pak_directory(data: bytes) -> dict:
    """PAK bytes -> {name: (offset, size)}."""
    magic, dir_off, dir_len = _HEADER.unpack_from(data, 0)
    if magic != b"PACK":
        raise ValueError("not a PAK archive (missing PACK magic)")
    if dir_len % _ENTRY.size:
        raise ValueError("corrupt PAK directory length")
    if dir_off < 0 or dir_len < 0 or dir_off + dir_len > len(data):
        raise ValueError("corrupt PAK directory")
    entries = {}
    for i in range(dir_len // _ENTRY.size):
        raw_name, off, size = _ENTRY.unpack_from(data, dir_off + i * _ENTRY.size)
        name = raw_name.split(b"\x00", 1)[0].decode("latin-1")
        if off < 0 or size < 0:
            # a negative offset/size would slice from the END of the
            # buffer — the ValueError-on-malformed-input contract
            raise ValueError(f"corrupt PAK entry {name!r} bounds")
        entries[name] = (off, size)
    return entries


def read_pak_entry(pak_path, name: str) -> bytes:
    """Extract one file from a PAK archive by its archive path
    (e.g. ``"gfx/palette.lmp"``)."""
    data = Path(pak_path).read_bytes()
    entries = read_pak_directory(data)
    if name not in entries:
        raise KeyError(f"{name!r} not in {pak_path} "
                       f"({len(entries)} entries)")
    off, size = entries[name]
    if off < 0 or size < 0 or off + size > len(data):
        raise ValueError("corrupt PAK entry bounds")
    return data[off : off + size]


def load_palette_from_pak(pak_path) -> np.ndarray:
    """The Quake base palette from a game PAK (``host_basepal``,
    ``NQ/host.c:832``) -> [256, 3] uint8."""
    from blinky_tpu_torch.palette import load_lmp

    return load_lmp(read_pak_entry(pak_path, "gfx/palette.lmp"))


def write_pak(path, files: dict) -> None:
    """Write a PAK archive from {name: bytes} (fixture/testing helper)."""
    body = bytearray(_HEADER.size)
    directory = bytearray()
    for name, blob in files.items():
        off = len(body)
        body += blob
        directory += _ENTRY.pack(name.encode("latin-1"), off, len(blob))
    dir_off = len(body)
    _HEADER.pack_into(body, 0, b"PACK", dir_off, len(directory))
    Path(path).write_bytes(bytes(body) + bytes(directory))
