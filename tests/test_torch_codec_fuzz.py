"""Codec robustness of the port against blinky_tpu, with
tests/test_codec_fuzz.py as the model: every decoder of
blinky_tpu_torch/io gets truncations, bit flips and random bytes, and on
each input it must do what blinky_tpu's decoder does: return the same
arrays, or raise the same exception type (ValueError, the modules'
contract), never crash otherwise or hang."""

import struct

import numpy as np
import pytest

from blinky_tpu.io import dataset as jdataset
from blinky_tpu.io import demfile as jdem
from blinky_tpu.io import gif as jgif
from blinky_tpu.io import pak as jpak
from blinky_tpu.io import pcx as jpcx
from blinky_tpu.io import png as jpng
from blinky_tpu.io import ppm as jppm
from blinky_tpu_torch.io import dataset, demfile, gif, pak, pcx, png, ppm
from blinky_tpu_torch.palette import default_palette


def _dem(mod):
    return lambda b: mod.read_dem(b, keep_messages=True)


DECODERS = {  # kind: (port decoder, JAX decoder)
    "png": (png.decode_png, jpng.decode_png),
    "ppm": (ppm.decode_ppm, jppm.decode_ppm),
    "pcx": (pcx.decode_pcx, jpcx.decode_pcx),
    "dem": (_dem(demfile), _dem(jdem)),
    "gif": (gif.decode_gif, jgif.decode_gif),
    "pak": (pak.read_pak_directory, jpak.read_pak_directory),
}


def _valid_samples():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (9, 13, 3), np.uint8)
    idx = rng.integers(0, 256, (9, 13), np.uint8)
    dem = bytearray(b"-1\n")
    for i in range(4):
        msg = bytes([1]) * (i + 1)
        dem += struct.pack("<i3f", len(msg), 1.0 * i, 2.0, 3.0) + msg
    body = bytearray(12)
    directory = bytearray()
    for name, blob in (("gfx/palette.lmp", default_palette().tobytes()), ("a/b", b"xyz")):
        directory += struct.pack("<56sii", name.encode(), len(body), len(blob))
        body += blob
    struct.pack_into("<4sii", body, 0, b"PACK", len(body), len(directory))
    return {
        "png": png.encode_png(img),
        "ppm": ppm.encode_ppm(img),
        "pcx": pcx.encode_pcx(idx, default_palette()),
        "dem": bytes(dem),
        "gif": gif.encode_gif(np.stack([idx, np.roll(idx, 3, 1)], axis=-1),
                              default_palette(), delay_cs=4),
        "pak": bytes(body + directory),
    }


def _flatten(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flatten(v)]
    if hasattr(x, "poses"):  # a DemFile
        return _flatten([x.cdtrack, x.poses, x.message_sizes, x.messages])
    if isinstance(x, dict):
        return _flatten(sorted(x.items()))
    return [x]


def _same(kind, data):
    """Both decoders on *data*: equal outputs, or the same exception type,
    which must be ValueError.  The PAK reader is the one exception: on a
    header or directory cut short, blinky_tpu's raises struct.error, and the
    port's, a copy, raises what it raises."""
    outs = []
    for decode in DECODERS[kind]:
        try:
            outs.append(("ok", _flatten(decode(data))))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            outs.append(("raised", type(e)))
    assert outs[0][0] == outs[1][0], (kind, outs)
    if outs[0][0] == "raised":
        assert outs[0][1] is outs[1][1], (kind, outs)
        assert outs[0][1] is ValueError or (kind == "pak" and outs[0][1] is struct.error)
        return
    a, b = outs[0][1], outs[1][1]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_truncations(kind):
    data = _valid_samples()[kind]
    DECODERS[kind][0](data)  # the intact sample parses
    for cut in range(0, len(data), max(1, len(data) // 40)):
        _same(kind, data[:cut])


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_bit_flips(kind):
    data = _valid_samples()[kind]
    rng = np.random.default_rng(1)
    for _ in range(200):
        i = int(rng.integers(len(data)))
        _same(kind, data[:i] + bytes([data[i] ^ (1 << int(rng.integers(8)))]) + data[i + 1:])


@pytest.mark.parametrize("kind", sorted(DECODERS))
def test_random_garbage(kind):
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 64, 500):
        _same(kind, bytes(rng.integers(0, 256, n, dtype=np.uint8)))


@pytest.mark.parametrize("text", ["1 2 3 4\n", "x y z\n", "1 2\n", "1 nan 2 3\n"])
def test_pose_track_garbage(text):
    for mod in (dataset, jdataset):
        with pytest.raises(ValueError):
            mod.parse_pose_track(text)


def test_dem_writer_rejects_bad_shapes(tmp_path):
    for mod in (demfile, jdem):
        with pytest.raises(ValueError, match="messages"):
            mod.write_dem(tmp_path / "x.dem", np.zeros((2, 3)), messages=[b"a"])
