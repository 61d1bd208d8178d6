"""The port's PNG and PPM codecs (blinky_tpu_torch/io/png.py, ppm.py)
against blinky_tpu's, with tests/test_png.py as the model: the same seeded
images give the same bytes, every decode the same array, and every error
path the same exception type (tolerance 0).  The CLI case
(``test_cli_png_output``) waits for the port's CLI (ROADMAP §1 item 8)."""

import struct
import zlib

import numpy as np
import pytest

from blinky_tpu.io import png as jpng
from blinky_tpu.io import ppm as jppm
from blinky_tpu_torch.io import png, ppm

SHAPES = [(37, 61, 3), (8, 8), (1, 1, 3), (1, 1), (5, 300, 3), (300, 5)]


def _img(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_encode_png_bytes_equal(shape, level):
    img = _img(shape)
    data = png.encode_png(img, compress_level=level)
    assert data == jpng.encode_png(img, compress_level=level)
    assert data.startswith(b"\x89PNG\r\n\x1a\n")
    out = png.decode_png(data)
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, jpng.decode_png(data))


def _chunk(tag, body):
    raw = tag + body
    return struct.pack(">I", len(body)) + raw + struct.pack(">I", zlib.crc32(raw) & 0xFFFFFFFF)


def _png_with_filter(img, f):
    """Re-encode an image with scanline filter f on every row (f = 5: the
    filter byte cycles 0-4 row by row)."""
    gray = img.ndim == 2
    if gray:
        img = img[..., None]
    h, w, c = img.shape
    prev = np.zeros(w * c, np.int32)
    rows = []
    for y in range(h):
        fy = y % 5 if f == 5 else f
        cur = img[y].reshape(-1).astype(np.int32)
        left = np.roll(cur, c)
        left[:c] = 0
        pl = np.roll(prev, c)
        pl[:c] = 0
        if fy == 0:
            enc = cur
        elif fy == 1:
            enc = cur - left
        elif fy == 2:
            enc = cur - prev
        elif fy == 3:
            enc = cur - ((left + prev) >> 1)
        else:  # paeth
            p = left + prev - pl
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - pl)
            enc = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, pl))
        rows.append(bytes([fy]) + (enc & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
@pytest.mark.parametrize("f", [0, 1, 2, 3, 4, 5])
def test_decoder_handles_standard_filters(f, gray):
    img = _img((9, 13) if gray else (9, 13, 3), seed=f)
    data = _png_with_filter(img, f)
    out = png.decode_png(data)
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, jpng.decode_png(data))


def _bad_pngs():
    whole = jpng.encode_png(np.zeros((4, 4, 3), np.uint8))
    crc = bytearray(whole)
    crc[-5] ^= 0xFF  # the IEND CRC
    body = whole[16:16 + 13] + b"\x00"  # a 14-byte IHDR with a valid CRC
    crafted = (whole[:8] + struct.pack(">I", 14) + b"IHDR" + body
               + struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF) + whole[33:])
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)
    sig = b"\x89PNG\r\n\x1a\n"
    return {
        "not_png": (b"P6\n1 1\n255\nxyz", "not a PNG"),
        "bad_crc": (bytes(crc), "CRC"),
        "truncated": (whole[:-14], "truncated"),
        "ihdr_length": (crafted, "IHDR length"),
        "no_ihdr": (sig + _chunk(b"IEND", b""), "missing IHDR"),
        "palette_type": (sig + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 3, 0, 0, 0))
                         + _chunk(b"IEND", b""), "unsupported"),
        "bad_zlib": (sig + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", b"nozlib")
                     + _chunk(b"IEND", b""), "bad PNG image data"),
        "size_mismatch": (sig + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(b"\0" * 7))
                          + _chunk(b"IEND", b""), "size mismatch"),
        "bad_filter": (sig + _chunk(b"IHDR", ihdr)
                       + _chunk(b"IDAT", zlib.compress((b"\x07" + b"\0" * 12) * 4))
                       + _chunk(b"IEND", b""), "filter"),
    }


@pytest.mark.parametrize("case", list(_bad_pngs()))
def test_decode_errors_match(case):
    data, match = _bad_pngs()[case]
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)
    with pytest.raises(ValueError, match=match):
        jpng.decode_png(data)


@pytest.mark.parametrize("shape", [(4, 4, 4), (4, 4, 1), (4,), (2, 2, 2, 3)], ids=str)
def test_encode_png_rejects_shapes(shape):
    for mod in (png, jpng):
        with pytest.raises(ValueError, match="expects"):
            mod.encode_png(np.zeros(shape, np.uint8))


@pytest.mark.parametrize("shape", [(9, 13, 3), (1, 1, 3), (40, 7, 3)], ids=str)
def test_ppm_bytes_equal(shape):
    img = _img(shape, seed=sum(shape))
    data = ppm.encode_ppm(img)
    assert data == jppm.encode_ppm(img)
    np.testing.assert_array_equal(ppm.decode_ppm(data), img)
    # comments and odd whitespace in the header
    data = b"P6 # made by hand\n%d\t%d\n255\n" % (shape[1], shape[0]) + img.tobytes()
    np.testing.assert_array_equal(ppm.decode_ppm(data), jppm.decode_ppm(data))


@pytest.mark.parametrize("data", [b"P5\n1 1\n255\n\0", b"P6\n1 1\n65535\n\0\0\0\0\0\0",
                                  b"P6\n2 2\n255\n\0", b"P6\nx 1\n255\n"])
def test_ppm_errors_match(data):
    for mod in (ppm, jppm):
        with pytest.raises(ValueError):
            mod.decode_ppm(data)
    for mod in (ppm, jppm):
        with pytest.raises(ValueError, match="expects"):
            mod.encode_ppm(np.zeros((2, 2, 4), np.uint8))
