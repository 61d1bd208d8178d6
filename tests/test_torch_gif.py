"""The port's animated GIF codec (blinky_tpu_torch/io/gif.py) against
blinky_tpu's, with tests/test_gif.py as the model: the same seeded frames
give the same bytes, every decode the same frames, palette and delays, and
every error path the same exception type (tolerance 0).  The CLI cases
(``reproject --format gif``) wait for the port's CLI (ROADMAP §1 item 8)."""

import io
import struct

import numpy as np
import pytest

from blinky_tpu.io import gif as jgif
from blinky_tpu_torch.io import gif
from blinky_tpu_torch.palette import default_palette

PIL = pytest.importorskip("PIL.Image", reason="Pillow is the independent check")


def _datasets():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, 10000).astype(np.uint8),
        "ramp": np.tile(np.arange(256, dtype=np.uint8), 50),
        "zeros_overflow": np.zeros(70000, np.uint8),
        "low_entropy": rng.integers(0, 4, 120000).astype(np.uint8),
        "empty": np.array([], np.uint8),
        "one": np.array([7], np.uint8),
    }


@pytest.mark.parametrize("name", list(_datasets()))
def test_lzw_python_and_native_bit_equal(name):
    """The Python LZW (O(1) table reset) and the native one, both packages."""
    data = _datasets()[name]
    enc = gif._lzw_encode_py(data, 8)
    assert enc == jgif._lzw_encode_py(data, 8) == gif._lzw_encode(data, 8)
    np.testing.assert_array_equal(gif._lzw_decode_py(enc, 8, data.size), data)
    np.testing.assert_array_equal(gif._lzw_decode(enc, 8, data.size), data)


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("delay,loop", [(7, 0), (0, 3), (65535, 65535)])
@pytest.mark.parametrize("shape", [(24, 40, 4), (1, 1, 1), (15, 20, 2), (3, 200, 5)], ids=str)
def test_container_bytes_equal(shape, delay, loop):
    pal = default_palette()
    frames = _frames(shape, sum(shape))
    data = gif.encode_gif(frames, pal, delay_cs=delay, loop=loop)
    assert data == jgif.encode_gif(frames, pal, delay_cs=delay, loop=loop)
    out, out_pal, delays = gif.decode_gif(data)
    np.testing.assert_array_equal(out, frames)
    np.testing.assert_array_equal(out_pal, pal)
    assert delays == [delay] * shape[2]


def test_pil_reads_the_ports_gif():
    pal = default_palette()
    frames = _frames((24, 40, 4), 1)
    im = PIL.open(io.BytesIO(gif.encode_gif(frames, pal, delay_cs=7)))
    assert im.n_frames == 4 and im.info.get("duration") == 70
    for i in range(4):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), pal[frames[..., i]])


def test_single_frame_and_list_inputs():
    pal = default_palette()
    f = np.arange(300, dtype=np.uint16).astype(np.uint8).reshape(15, 20)
    for frames in (f, [f, f[::-1]], (f,), np.stack([f, f], -1)):
        assert gif.encode_gif(frames, pal) == jgif.encode_gif(frames, pal)
    np.testing.assert_array_equal(gif.decode_gif(gif.encode_gif([f, f[::-1]], pal))[0][..., 1],
                                  f[::-1])


@pytest.mark.parametrize("seed", [2, 3])
def test_decode_pil_written_gif(seed):
    """A third-party GIF (Pillow: per-frame boxes, local tables, its own
    LZW packer) decodes to the JAX package's frames and palette."""
    rng = np.random.default_rng(seed)
    pal = default_palette()
    frames = rng.integers(0, 64, (20, 30, 3)).astype(np.uint8)
    imgs = [PIL.fromarray(pal[frames[..., i]]).quantize(colors=256) for i in range(3)]
    buf = io.BytesIO()
    imgs[0].save(buf, format="GIF", save_all=True, append_images=imgs[1:], duration=40,
                 loop=0)
    got, want = gif.decode_gif(buf.getvalue()), jgif.decode_gif(buf.getvalue())
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == [4, 4, 4]


def _lct_gif():
    """A second image whose local table permutes the global one."""
    pal = default_palette()
    f0 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    data = bytearray(jgif.encode_gif(f0, pal))
    f1_local = np.arange(256)[::-1].astype(np.uint8)[f0]
    lct = np.zeros((256, 3), np.uint8)
    lct[f1_local.reshape(-1), :] = pal[f0.reshape(-1), :]
    img = b"\x2c" + struct.pack("<HHHHB", 0, 0, 16, 16, 0x87)
    img += lct.tobytes() + bytes([8]) + jgif._subblocks(jgif._lzw_encode(f1_local, 8))
    return bytes(data[:-1]) + img + b"\x3b", pal, f0


def _gce_gif():
    """A GCE (transparency, disposal 2, delay 9) before frame 0 only."""
    pal = default_palette()
    f0 = np.full((4, 6), 7, np.uint8)
    f1 = np.zeros((4, 6), np.uint8)
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", 6, 4, 0xF7, 99, 0) + pal.tobytes())
    out += b"\x21\xf9" + bytes([4, (2 << 2) | 1]) + struct.pack("<H", 9) + bytes([0, 0])
    out += b"\x2c" + struct.pack("<HHHHB", 0, 0, 6, 4, 0)
    out += bytes([8]) + jgif._subblocks(jgif._lzw_encode(f0, 8))
    out += b"\x2c" + struct.pack("<HHHHB", 0, 0, 6, 4, 0)
    out += bytes([8]) + jgif._subblocks(jgif._lzw_encode(f1, 8)) + b"\x3b"
    return bytes(out), f1


def _interlaced_gif():
    """An interlaced image with no global table and disposal 3."""
    f = np.arange(13 * 7, dtype=np.uint8).reshape(13, 7)
    rows = np.concatenate([np.arange(0, 13, 8), np.arange(4, 13, 8), np.arange(2, 13, 4),
                           np.arange(1, 13, 2)])
    lct = default_palette()[::-1].copy()
    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", 7, 13, 0x00, 0, 0))
    out += b"\x21\xf9" + bytes([4, 3 << 2]) + struct.pack("<H", 2) + bytes([0, 0])
    out += b"\x2c" + struct.pack("<HHHHB", 0, 0, 7, 13, 0xC7) + lct.tobytes()
    out += bytes([8]) + jgif._subblocks(jgif._lzw_encode(f[rows], 8)) + b"\x3b"
    return bytes(out), f


def test_decode_local_color_table_permutation_is_exact():
    data, pal, f0 = _lct_gif()
    out, out_pal, _ = gif.decode_gif(data)
    np.testing.assert_array_equal(out, jgif.decode_gif(data)[0])
    np.testing.assert_array_equal(out_pal[out[..., 1]], pal[f0])


def test_gce_scope_resets_per_image():
    data, f1 = _gce_gif()
    frames, _, delays = gif.decode_gif(data)
    assert delays == [9, 0] == jgif.decode_gif(data)[2]
    np.testing.assert_array_equal(frames[..., 1], f1)
    np.testing.assert_array_equal(frames, jgif.decode_gif(data)[0])


def test_interlaced_image_without_global_table():
    data, f = _interlaced_gif()
    frames, pal, delays = gif.decode_gif(data)
    want = jgif.decode_gif(data)
    np.testing.assert_array_equal(frames[..., 0], f)
    np.testing.assert_array_equal(frames, want[0])
    np.testing.assert_array_equal(pal, want[1])
    assert delays == want[2] == [2]


def test_delta_rect_encoding_roundtrips_and_shrinks():
    pal = default_palette()
    base = np.random.default_rng(9).integers(0, 256, (60, 80), np.uint8)
    frames = np.repeat(base[..., None], 8, axis=-1).copy()
    for b in range(1, 8):  # a small moving sprite
        frames[10 + b:14 + b, 20 + b:26 + b, b] = b
    data = gif.encode_gif(frames, pal, delay_cs=4)
    assert data == jgif.encode_gif(frames, pal, delay_cs=4)
    np.testing.assert_array_equal(gif.decode_gif(data)[0], frames)
    two = gif.encode_gif(np.stack([base, base], -1), pal)
    assert len(two) - len(gif.encode_gif(base, pal)) < 80  # an unchanged frame is ~1x1


@pytest.mark.parametrize("n", [1, 3])
def test_encode_gif_u32_bytes_equal(n):
    """Packed-RGBA screens through one median-cut palette."""
    rng = np.random.default_rng(n)
    screens = (rng.integers(0, 2**24, (n, 18, 22), dtype=np.int64).astype(np.uint32)
               | np.uint32(0xFF000000))
    screens[:, :5] = screens[0, 0, 0]
    data = gif.encode_gif_u32(screens, delay_cs=3)
    assert data == jgif.encode_gif_u32(screens, delay_cs=3)
    assert data == gif.encode_gif_u32(list(screens), delay_cs=3)
    assert gif.decode_gif(data)[0].shape == (18, 22, n)


def _bad_encodes():
    pal = default_palette()
    f = np.zeros((4, 4), np.uint8)
    return {
        "frames_ndim": lambda m: m.encode_gif(np.zeros((2, 3, 4, 5), np.uint8), pal),
        "palette": lambda m: m.encode_gif(f, np.zeros((16, 3), np.uint8)),
        "no_frames": lambda m: m.encode_gif(np.zeros((4, 4, 0), np.uint8), pal),
        "too_wide": lambda m: m.encode_gif(np.zeros((1, 65536), np.uint8), pal),
        "delay": lambda m: m.encode_gif(np.stack([f, f], -1), pal, delay_cs=70000),
        "loop": lambda m: m.encode_gif(np.stack([f, f], -1), pal, loop=-1),
    }


@pytest.mark.parametrize("case", list(_bad_encodes()))
def test_encode_gif_validates_inputs(case):
    call = _bad_encodes()[case]
    with pytest.raises(ValueError) as got:
        call(gif)
    with pytest.raises(ValueError) as want:
        call(jgif)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [3, 4])
def test_python_decoder_fuzz_error_contract(seed):
    """The Python LZW decoder on cut and flipped streams: the same pixels
    as the JAX package's, or the same ValueError."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, 500).astype(np.uint8)
    enc = gif._lzw_encode_py(data, 8)
    cases = [enc[:cut] for cut in range(0, len(enc), 17)]
    for _ in range(100):
        i = int(rng.integers(len(enc)))
        cases.append(enc[:i] + bytes([enc[i] ^ (1 << int(rng.integers(8)))]) + enc[i + 1:])
    for bad in cases:
        outs = []
        for mod in (gif, jgif):
            try:
                outs.append(mod._lzw_decode_py(bad, 8, data.size))
            except ValueError:
                outs.append(None)
        assert (outs[0] is None) == (outs[1] is None)
        if outs[0] is not None:
            np.testing.assert_array_equal(outs[0], outs[1])
