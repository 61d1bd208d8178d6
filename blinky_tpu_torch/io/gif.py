"""Animated GIF codec for palettized frame sequences.

The reference era's native animation container is a perfect fit for this
framework's frames: both are 8-bit indices into a 256-color palette (the
engine's whole video model, ``include/vid.h:40``), so demo-playback
output exports losslessly — no quantization, no external tools.  The
reference itself only exports single PCX stills (``WritePCXfile``,
``common/screen.c:681``); this is the moving-picture counterpart for the
``reproject`` pipeline (``--format gif``).

Encoder: GIF89a, one global 256-color table, a NETSCAPE2.0 loop block
for animations, full-canvas frames.  The LZW codestream is produced by
the native C++ runtime when built (``gif_lzw_encode``; ~100x the Python
fallback).  Decoder accepts standard third-party GIFs (local color
tables, frame offsets, transparency, disposal methods 0-2) and raises
``ValueError`` on any malformed input — the io/ codecs' shared error
contract (tests/test_codec_fuzz.py).
"""

from __future__ import annotations

import struct

import numpy as np

from blinky_tpu_torch import native


# ------------------------------------------------------------- LZW core

def _lzw_encode_py(pixels: np.ndarray, min_code_size: int) -> bytes:
    """Pure-Python fallback, bit-identical to the native encoder."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    width = min_code_size + 1
    next_code = eoi + 1
    table: dict = {}
    out = bytearray()
    acc = nbits = 0

    def put(code, w):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += w
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    put(clear, width)
    px = pixels.reshape(-1)
    if px.size:
        prefix = int(px[0])
        for c in px[1:].tolist():
            key = (prefix, c)
            hit = table.get(key)
            if hit is not None:
                prefix = hit
                continue
            put(prefix, width)
            if next_code < 4096:
                # bump on the PRE-add counter — the encoder's table runs
                # one entry ahead of the decoder's (see the native
                # encoder's comment)
                if next_code == (1 << width) and width < 12:
                    width += 1
                table[key] = next_code
                next_code += 1
            else:
                put(clear, width)
                table.clear()
                width = min_code_size + 1
                next_code = eoi + 1
            prefix = c
        put(prefix, width)
    put(eoi, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _lzw_decode_py(stream: bytes, min_code_size: int, total: int) -> np.ndarray:
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    width = min_code_size + 1
    next_code = eoi + 1
    prefix = [0] * 4096
    suffix = [0] * 4096
    out = np.empty(total, dtype=np.uint8)
    written = 0
    prev = -1
    bitpos = 0
    nbits_total = len(stream) * 8
    while True:
        if bitpos + width > nbits_total:
            raise ValueError("corrupt GIF LZW stream")
        code = 0
        for b in range(width):
            code |= ((stream[bitpos >> 3] >> (bitpos & 7)) & 1) << b
            bitpos += 1
        if code == clear:
            width = min_code_size + 1
            next_code = eoi + 1
            prev = -1
            continue
        if code == eoi:
            break
        stack = []
        if prev < 0:
            if code >= clear:
                raise ValueError("corrupt GIF LZW stream")
            stack.append(code)
        elif code < next_code:
            cur = code
            while cur >= clear + 2:
                stack.append(suffix[cur])
                cur = prefix[cur]
            stack.append(cur)
        elif code == next_code and next_code < 4096:
            cur = prev
            while cur >= clear + 2:
                stack.append(suffix[cur])
                cur = prefix[cur]
            stack.append(cur)
            stack.insert(0, stack[-1])  # KwKwK: first char repeated
        else:
            raise ValueError("corrupt GIF LZW stream")
        n = len(stack)
        if written + n > total:
            raise ValueError("corrupt GIF LZW stream")
        out[written:written + n] = stack[::-1]
        written += n
        if prev >= 0 and next_code < 4096:
            prefix[next_code] = prev
            suffix[next_code] = stack[-1]
            next_code += 1
            if next_code == (1 << width) and width < 12:
                width += 1
        prev = code
    return out[:written]


def _lzw_encode(pixels: np.ndarray, min_code_size: int) -> bytes:
    enc = native.gif_lzw_encode(pixels, min_code_size)
    return enc if enc is not None else _lzw_encode_py(pixels, min_code_size)


def _lzw_decode(stream: bytes, min_code_size: int, total: int) -> np.ndarray:
    dec = native.gif_lzw_decode(stream, min_code_size, total)
    return dec if dec is not None else _lzw_decode_py(stream, min_code_size, total)


def _subblocks(data: bytes) -> bytes:
    """Wrap raw bytes into GIF's <=255-byte sub-block framing."""
    out = bytearray()
    for i in range(0, len(data), 255):
        chunk = data[i:i + 255]
        out.append(len(chunk))
        out += chunk
    out.append(0)  # block terminator
    return bytes(out)


# ------------------------------------------------------------ container

def encode_gif(frames, palette: np.ndarray, delay_cs: int = 5,
               loop: int = 0) -> bytes:
    """Encode palettized frames as a (possibly animated) GIF89a.

    ``frames``: [H, W] u8, [H, W, B] u8 (batch-innermost, like every
    screen batch in this framework), or a list of [H, W] u8 arrays.
    ``palette``: [256, 3] u8.  ``delay_cs``: per-frame delay in
    centiseconds (GIF's native unit; 5 = 20 fps).  ``loop``: animation
    repeat count, 0 = forever.
    """
    if isinstance(frames, (list, tuple)):
        frames = np.stack([np.asarray(f, np.uint8) for f in frames], axis=-1)
    frames = np.asarray(frames, dtype=np.uint8)
    if frames.ndim == 2:
        frames = frames[..., None]
    if frames.ndim != 3:
        raise ValueError("encode_gif expects [H, W] or [H, W, B] u8 frames")
    palette = np.ascontiguousarray(palette, dtype=np.uint8)
    if palette.shape != (256, 3):
        raise ValueError("encode_gif expects a [256, 3] u8 palette")
    h, w, nframes = frames.shape
    if nframes < 1:
        raise ValueError("encode_gif needs at least one frame")
    if not (0 < w <= 0xFFFF and 0 < h <= 0xFFFF):
        raise ValueError("GIF dimensions must be 1..65535")
    if not (0 <= int(delay_cs) <= 0xFFFF and 0 <= int(loop) <= 0xFFFF):
        raise ValueError("delay_cs and loop must fit uint16")
    out = bytearray()
    out += b"GIF89a"
    # logical screen descriptor: global color table, 8 bits/entry, 256
    out += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
    out += palette.tobytes()
    if nframes > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0"
        out += bytes([3, 1]) + struct.pack("<H", int(loop)) + b"\x00"
    prev = None
    for b in range(nframes):
        cur = frames[..., b]
        # delta-rect optimization: encode only the bounding box of the
        # pixels that changed since the previous frame (the decoder's
        # disposal-0 compositing reproduces the full frame exactly) —
        # a large win for mostly-static scenes like viewer captures
        fx = fy = 0
        fw, fh = w, h
        rect = cur
        if prev is not None:
            diff = cur != prev
            if not diff.any():
                fy = fx = 0
                fw = fh = 1
                rect = cur[:1, :1]
            else:
                rows = np.flatnonzero(diff.any(axis=1))
                cols = np.flatnonzero(diff.any(axis=0))
                fy, fx = int(rows[0]), int(cols[0])
                fh = int(rows[-1]) - fy + 1
                fw = int(cols[-1]) - fx + 1
                rect = cur[fy:fy + fh, fx:fx + fw]
        prev = cur
        # graphic control extension (delay; no transparency)
        out += b"\x21\xf9" + bytes([4, 0]) + struct.pack(
            "<H", int(delay_cs)) + bytes([0, 0])
        out += b"\x2c" + struct.pack("<HHHHB", fx, fy, fw, fh, 0)
        out += bytes([8])  # LZW min code size
        out += _subblocks(_lzw_encode(np.ascontiguousarray(rect), 8))
    out += b"\x3b"  # trailer
    return bytes(out)


def encode_gif_u32(screens, delay_cs: int = 5, loop: int = 0) -> bytes:
    """Encode packed-RGBA u32 screens as one quantized animated GIF.

    The true-color export bridge used by ``reproject --format gif`` and
    the viewer's ``/record.gif``: unpacks, builds ONE global median-cut
    palette over the whole sequence (``palette.quantize_rgb``), then
    encodes losslessly in palette space.  ``screens``: a list of [H, W]
    u32 arrays or an [N, H, W] u32 array — the batch axis must LEAD.
    A batch-innermost [H, W, N] screen stack (Session.render's layout)
    must be ``moveaxis(-1, 0)``'d by the caller; it cannot be told apart
    from [N, H, W] here, and encoding it as-is would transpose frames.
    """
    from blinky_tpu_torch.kernels.remap import unpack_rgb
    from blinky_tpu_torch.palette import quantize_rgb

    if isinstance(screens, (list, tuple)):
        screens = np.stack([np.asarray(s) for s in screens])
    screens = np.asarray(screens)
    pal, idx = quantize_rgb(np.stack([unpack_rgb(s) for s in screens]))
    return encode_gif(np.moveaxis(idx, 0, -1), pal, delay_cs=delay_cs,
                      loop=loop)


def _read_subblocks(data: bytes, pos: int):
    """Collect sub-blocks starting at *pos*; returns (bytes, new_pos)."""
    chunks = []
    n = len(data)
    while True:
        if pos >= n:
            raise ValueError("truncated GIF")
        size = data[pos]
        pos += 1
        if size == 0:
            return b"".join(chunks), pos
        if pos + size > n:
            raise ValueError("truncated GIF")
        chunks.append(data[pos:pos + size])
        pos += size


def decode_gif(data: bytes):
    """Decode a GIF into ``(frames, palette, delays_cs)``.

    ``frames`` is [H, W, B] u8 palette indices on the full canvas
    (partial frames are composited per the disposal model), ``palette``
    is the global [256, 3] table (zero-padded if smaller).  A frame with
    a local color table is remapped onto the global palette with the
    reference's nearest-color search (first-minimum squared-RGB, like
    ``find_closest_pal_index``, ``fisheye.c:835-855``) — 256 lookups per
    frame, exact whenever the local colors also appear globally.  If the
    file has no global table at all, the first local table becomes the
    returned palette.  Raises ``ValueError`` on malformed input.
    """
    if len(data) < 13 or data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, flags, bgcolor, _ = struct.unpack("<HHBBB", data[6:13])
    pos = 13
    palette = np.zeros((256, 3), dtype=np.uint8)
    have_gct = bool(flags & 0x80)
    if have_gct:
        ncols = 2 << (flags & 7)
        if pos + 3 * ncols > len(data):
            raise ValueError("truncated GIF")
        palette[:ncols] = np.frombuffer(
            data[pos:pos + 3 * ncols], np.uint8).reshape(ncols, 3)
        pos += 3 * ncols
    frames = []
    delays = []
    canvas = np.full((h, w), bgcolor, dtype=np.uint8)
    transparent = -1
    disposal = 0
    delay = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated GIF (missing trailer)")
        block = data[pos]
        pos += 1
        if block == 0x3B:  # trailer
            break
        if block == 0x21:  # extension
            if pos >= len(data):
                raise ValueError("truncated GIF")
            label = data[pos]
            pos += 1
            body, pos = _read_subblocks(data, pos)
            if label == 0xF9 and len(body) >= 4:
                gflags = body[0]
                delay = struct.unpack("<H", body[1:3])[0]
                disposal = (gflags >> 2) & 7
                transparent = body[3] if gflags & 1 else -1
            continue
        if block != 0x2C:
            raise ValueError(f"unknown GIF block 0x{block:02x}")
        if pos + 9 > len(data):
            raise ValueError("truncated GIF")
        fx, fy, fw, fh, iflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        if fx + fw > w or fy + fh > h or fw == 0 or fh == 0:
            raise ValueError("GIF frame rect outside canvas")
        lct = None
        if iflags & 0x80:  # local color table
            ncols = 2 << (iflags & 7)
            if pos + 3 * ncols > len(data):
                raise ValueError("truncated GIF")
            lct = np.zeros((256, 3), dtype=np.uint8)
            lct[:ncols] = np.frombuffer(
                data[pos:pos + 3 * ncols], np.uint8).reshape(ncols, 3)
            pos += 3 * ncols
            if not have_gct:
                palette[:] = lct  # adopt the first table seen
                have_gct = True
                lct = None
            elif np.array_equal(lct, palette):
                lct = None
        if pos >= len(data):
            raise ValueError("truncated GIF")
        mcs = data[pos]
        pos += 1
        if not 2 <= mcs <= 8:
            raise ValueError("bad GIF LZW min code size")
        stream, pos = _read_subblocks(data, pos)
        px = _lzw_decode(stream, mcs, fw * fh)
        if px.size != fw * fh:
            raise ValueError("GIF frame pixel count mismatch")
        rect = px.reshape(fh, fw)
        if iflags & 0x40:  # interlaced: undo the 4-pass row order
            deinter = np.empty_like(rect)
            rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                   np.arange(2, fh, 4), np.arange(1, fh, 2)])
            deinter[rows] = rect
            rect = deinter
        mask = (rect != transparent) if transparent >= 0 else None
        if lct is not None:
            # remap the frame's local indices onto the global palette
            # (first-minimum nearest color, fisheye.c:835-855)
            from blinky_tpu_torch.palette import find_closest_pal_index

            lut = np.asarray(
                find_closest_pal_index(palette, lct[:, 0].astype(np.int64),
                                       lct[:, 1].astype(np.int64),
                                       lct[:, 2].astype(np.int64)),
                dtype=np.uint8)
            rect = lut[rect]
        prev = canvas.copy()
        target = canvas[fy:fy + fh, fx:fx + fw]
        if mask is not None:
            target[mask] = rect[mask]
        else:
            target[:] = rect
        frames.append(canvas.copy())
        delays.append(delay)
        if disposal == 2:  # restore to background
            canvas[fy:fy + fh, fx:fx + fw] = bgcolor
        elif disposal == 3:  # restore to previous
            canvas = prev
        # disposal 0/1: leave as-is
        # a Graphic Control Extension governs only the single following
        # image (GIF89a spec 23); reset for the next block
        transparent = -1
        disposal = 0
        delay = 0
    if not frames:
        raise ValueError("GIF contains no image")
    return np.stack(frames, axis=-1), palette, delays
