"""The port's PAK archive reader (blinky_tpu_torch/io/pak.py) against
blinky_tpu's, with tests/test_pak.py as the model: the same archives give
the same directory, entries and palette, and every malformed archive the
same exception type (tolerance 0)."""

import struct

import numpy as np
import pytest

from blinky_tpu.io import pak as jpak
from blinky_tpu_torch.io import pak
from blinky_tpu_torch.palette import default_palette, load_lmp


def _files(seed):
    rng = np.random.default_rng(seed)
    pal = default_palette() if seed == 0 else rng.integers(0, 256, (256, 3), np.uint8)
    return {
        "gfx/palette.lmp": pal.tobytes(),
        "maps/e1m1.bsp": bytes(rng.integers(0, 256, 300 + seed, dtype=np.uint8)),
        "sound/misc/menu1.wav": b"RIFFdata",
        "empty": b"",
        "x" * 55: b"longest name",
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pak_roundtrip(tmp_path, seed):
    files = _files(seed)
    a, b = tmp_path / "port.pak", tmp_path / "jax.pak"
    pak.write_pak(a, files)
    jpak.write_pak(b, files)
    assert a.read_bytes() == b.read_bytes()
    d = pak.read_pak_directory(a.read_bytes())
    assert d == jpak.read_pak_directory(a.read_bytes())
    assert set(d) == set(files)
    for name, blob in files.items():
        assert pak.read_pak_entry(a, name) == blob == jpak.read_pak_entry(a, name)
    pal = pak.load_palette_from_pak(a)
    np.testing.assert_array_equal(pal, jpak.load_palette_from_pak(a))
    np.testing.assert_array_equal(pal, load_lmp(files["gfx/palette.lmp"]))


def _bad_archives():
    body = b"PAYLOADBYTES"
    ok_dir = struct.pack("<56sii", b"a", 12, 4)
    return {
        "magic": b"JUNK" + b"\x00" * 8,
        "dir_past_end": struct.pack("<4sii", b"PACK", 10_000, 64),
        "dir_negative": struct.pack("<4sii", b"PACK", -4, 64),
        "dir_length": struct.pack("<4sii", b"PACK", 12, 63) + b"\0" * 63,
        "entry_negative": (b"PACK" + struct.pack("<ii", 12 + len(body), 64) + body
                           + struct.pack("<56sii", b"gfx/palette.lmp", -100, 50)),
        "entry_past_end": b"PACK" + struct.pack("<ii", 12, 64)
                          + struct.pack("<56sii", b"a", 12, 4000),
        "short_header": b"PACK",
        "good": b"PACK" + struct.pack("<ii", 12, 64) + ok_dir,
    }


@pytest.mark.parametrize("case", list(_bad_archives()))
def test_malformed_archives_raise_alike(tmp_path, case):
    data = _bad_archives()[case]
    p = tmp_path / "bad.pak"
    p.write_bytes(data)
    for call in (lambda m: m.read_pak_directory(data), lambda m: m.read_pak_entry(p, "a"),
                 lambda m: m.load_palette_from_pak(p)):
        outs = []
        for mod in (pak, jpak):
            try:
                r = call(mod)
                outs.append(("ok", r.tobytes() if isinstance(r, np.ndarray) else r))
            except Exception as e:  # noqa: BLE001 - the type is what is compared
                outs.append(("raised", type(e)))
        assert outs[0] == outs[1]


def test_missing_entry_is_a_key_error(tmp_path):
    pak.write_pak(tmp_path / "ok.pak", {"a": b"1"})
    for mod in (pak, jpak):
        with pytest.raises(KeyError):
            mod.read_pak_entry(tmp_path / "ok.pak", "missing")
        with pytest.raises(KeyError):
            mod.load_palette_from_pak(tmp_path / "ok.pak")
