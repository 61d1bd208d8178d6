"""The port's own native library (blinky_tpu_torch/native) against
blinky_tpu.native: the same source and flags, built into
blinky_tpu_torch/build/, so every entry point gives the same bytes on the
same seeded inputs (tolerance 0).  Also: the NumPy fallbacks equal both,
the port opens nothing under blinky_tpu/, and two processes building at
once both load a whole library."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from blinky_tpu import native as jnative
from blinky_tpu import palette as jpalette
from blinky_tpu.io import gif as jgif
from blinky_tpu.io import png as jpng
from blinky_tpu_torch import native
from blinky_tpu_torch import palette
from blinky_tpu_torch.io import gif, png

REPO = Path(__file__).resolve().parents[1]
LIBM_UNARY = ["sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh",
              "log", "log10", "exp", "sqrt"]
LIBM_BINARY = ["arctan2", "fmod", "power", "hypot"]


def test_port_builds_its_own_library():
    assert native.available() and jnative.available()
    assert native.LIBRARY == REPO / "blinky_tpu_torch" / "build" / "libblinky_native.so"
    assert native.LIBRARY.exists()
    assert native.SOURCE == REPO / "blinky_tpu_torch" / "native" / "src" / "blinky_native.cpp"
    # the port's copy of the source compiles to the JAX package's code
    assert native.LIBRARY.stat().st_mtime >= native.SOURCE.stat().st_mtime
    assert native._load()._name == str(native.LIBRARY)


def test_flags_are_the_makefiles():
    make = (REPO / "blinky_tpu" / "native" / "Makefile").read_text()
    line = next(s for s in make.splitlines() if s.startswith("CXXFLAGS"))
    assert line.split("?=")[1].split() == native.CXXFLAGS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_palmap_bit_equal(seed):
    rng = np.random.default_rng(seed)
    pal = palette.default_palette() if seed == 0 else rng.integers(0, 256, (256, 3), np.uint8)
    got = native.palmap_build(pal)
    np.testing.assert_array_equal(got, jnative.palmap_build(pal))
    # the NumPy path (create_palmap without the native shortcut)
    base = pal.astype(np.int64)
    tinted = np.clip(base[None] + (((256 // 6) * (palette.PLATE_TINTS[:, None, :] - base))
                                   >> 8), 0, 255)
    np.testing.assert_array_equal(got, palette.find_closest_pal_index(
        pal, tinted[..., 0], tinted[..., 1], tinted[..., 2]))


@pytest.mark.parametrize("mode", ["reference", "rle"])
@pytest.mark.parametrize("shape", [(64, 80), (1, 1), (7, 193), (33, 32)])
def test_pcx_bodies_bit_equal(mode, shape):
    rng = np.random.default_rng(shape[0] * shape[1])
    img = rng.integers(0, 256, shape, np.uint8)
    img[:, : shape[1] // 2] = img[0, 0]  # long runs as well as noise
    body = native.pcx_encode_body(img, mode)
    assert body == jnative.pcx_encode_body(img, mode)
    np.testing.assert_array_equal(native.pcx_decode_body(body, img.size), img.reshape(-1))
    np.testing.assert_array_equal(jnative.pcx_decode_body(body, img.size), img.reshape(-1))
    for cut in (0, len(body) // 2, len(body) - 1):
        if cut < len(body):
            _same_outcome(lambda m: m.pcx_decode_body(body[:cut], img.size))


def _same_outcome(call):
    """call(module) on both natives: equal results or the same exception."""
    results = []
    for mod in (native, jnative):
        try:
            results.append(("ok", call(mod)))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            results.append(("raised", type(e)))
    assert results[0][0] == results[1][0], results
    if results[0][0] == "ok":
        a, b = results[0][1], results[1][1]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    else:
        assert results[0][1] is results[1][1]


@pytest.mark.parametrize("nthreads", [None, 1, 3])
def test_pcx_decode_body_many_bit_equal(nthreads):
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (32, 32), np.uint8) for _ in range(9)]
    imgs[2][:] = 7
    bodies = [native.pcx_encode_body(i, "rle" if k % 2 else "reference")
              for k, i in enumerate(imgs)]
    got = native.pcx_decode_body_many(bodies, imgs[0].size, nthreads)
    np.testing.assert_array_equal(got, jnative.pcx_decode_body_many(bodies, imgs[0].size,
                                                                    nthreads))
    np.testing.assert_array_equal(got, np.stack(imgs).reshape(9, -1))
    bodies[4] = bodies[4][:-5]
    _same_outcome(lambda m: m.pcx_decode_body_many(bodies, imgs[0].size, nthreads))


@pytest.mark.parametrize("shape", [(7, 6, 16, 16), (1, 6, 3, 3), (64, 2, 8, 8), (5, 12, 9, 9)])
def test_pack_unpack_bit_equal(shape):
    rng = np.random.default_rng(sum(shape))
    fr = rng.integers(0, 256, shape, np.uint8)
    pk = native.pack_batch(fr)
    np.testing.assert_array_equal(pk, jnative.pack_batch(fr))
    np.testing.assert_array_equal(pk, np.moveaxis(fr, 0, -1))
    un = native.unpack_batch(pk)
    np.testing.assert_array_equal(un, jnative.unpack_batch(pk))
    np.testing.assert_array_equal(un, fr)


def _filtered_scan(h, w, channels, seed):
    """[h, 1 + w*channels] scanlines with every filter byte 0-4."""
    rng = np.random.default_rng(seed)
    scan = rng.integers(0, 256, (h, 1 + w * channels), np.uint8)
    scan[:, 0] = np.arange(h) % 5
    return scan


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("hw", [(1, 1), (9, 13), (40, 3)])
def test_png_unfilter_bit_equal(channels, hw):
    scan = _filtered_scan(*hw, channels, seed=hw[0] + channels)
    got = native.png_unfilter(scan, channels)
    np.testing.assert_array_equal(got, jnative.png_unfilter(scan, channels))
    np.testing.assert_array_equal(got, png._unfilter(scan, channels))  # the NumPy path
    np.testing.assert_array_equal(got, jpng._unfilter(scan, channels))
    bad = scan.copy()
    bad[-1, 0] = 5
    _same_outcome(lambda m: m.png_unfilter(bad, channels))


def _lzw_datasets():
    rng = np.random.default_rng(0)
    return {
        "random": rng.integers(0, 256, 10000).astype(np.uint8),
        "ramp": np.tile(np.arange(256, dtype=np.uint8), 50),
        "zeros_overflow": np.zeros(70000, np.uint8),
        "low_entropy": rng.integers(0, 4, 120000).astype(np.uint8),
        "empty": np.array([], np.uint8),
        "one": np.array([7], np.uint8),
    }


@pytest.mark.parametrize("name", list(_lzw_datasets()))
def test_gif_lzw_bit_equal(name):
    data = _lzw_datasets()[name]
    for mcs in (2, 8) if data.max(initial=0) < 4 else (8,):
        enc = native.gif_lzw_encode(data, mcs)
        assert enc == jnative.gif_lzw_encode(data, mcs)
        assert enc == gif._lzw_encode_py(data, mcs) == jgif._lzw_encode_py(data, mcs)
        np.testing.assert_array_equal(native.gif_lzw_decode(enc, mcs, data.size), data)
        np.testing.assert_array_equal(jnative.gif_lzw_decode(enc, mcs, data.size), data)
        np.testing.assert_array_equal(gif._lzw_decode_py(enc, mcs, data.size), data)
        rng = np.random.default_rng(len(enc))
        for _ in range(20):  # corrupt streams: the same bytes or the same error
            i = int(rng.integers(max(len(enc), 1)))
            bad = enc[:i] + bytes([enc[i] ^ (1 << int(rng.integers(8)))]) + enc[i + 1:] \
                if enc else b"\xff"
            _same_outcome(lambda m: m.gif_lzw_decode(bad, mcs, data.size))


@pytest.mark.parametrize("op", LIBM_UNARY)
def test_libm_unary_bit_equal(op):
    from blinky_tpu.xmath import _LIBM_UNARY

    rng = np.random.default_rng(_LIBM_UNARY[op])
    x = np.concatenate([rng.uniform(-4, 4, 5000), rng.uniform(-1, 1, 5000),
                        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-300, 710.0]])
    with np.errstate(all="ignore"):
        got = native.libm_unary(_LIBM_UNARY[op], x)
        np.testing.assert_array_equal(got.view(np.int64),
                                      jnative.libm_unary(_LIBM_UNARY[op], x).view(np.int64))
    assert native.libm_unary(_LIBM_UNARY[op], np.float64(0.5)).ndim == 0


@pytest.mark.parametrize("op", LIBM_BINARY)
def test_libm_binary_bit_equal(op):
    from blinky_tpu.xmath import _LIBM_BINARY

    rng = np.random.default_rng(10 + _LIBM_BINARY[op])
    a = rng.uniform(-8, 8, (100, 70))
    b = rng.uniform(-8, 8, (100, 70))
    got = native.libm_binary(_LIBM_BINARY[op], a, b)
    np.testing.assert_array_equal(got.view(np.int64),
                                  jnative.libm_binary(_LIBM_BINARY[op], a, b).view(np.int64))
    row = b[:1]  # a smaller b is broadcast, not read past its end
    np.testing.assert_array_equal(native.libm_binary(_LIBM_BINARY[op], a, row).view(np.int64),
                                  jnative.libm_binary(_LIBM_BINARY[op], a, row).view(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_forward_rasterize_plate_bit_equal(seed):
    """The quad fill on seeded corner grids: the same tables written in place."""
    rng = np.random.default_rng(seed)
    S, H, W = 12, 30, 40
    base_x = np.linspace(-3, W + 3, S + 1)[None, :] + rng.normal(0, 1.5, (S + 1, S + 1))
    base_y = np.linspace(-3, H + 3, S + 1)[:, None] + rng.normal(0, 1.5, (S + 1, S + 1))
    lx, ly = base_x.astype(np.int32), base_y.astype(np.int32)
    ok = rng.random((S + 1, S + 1)) < 0.9
    owned = rng.random((S, S)) < 0.8
    offgrid = rng.random((S, S)) < 0.7
    tables = []
    for mod in (native, jnative):
        t = (np.full((H, W), -1, np.int32), np.zeros((H, W), np.int32),
             np.zeros((H, W), np.int32), np.zeros((H, W), np.uint8))
        wrote = mod.forward_rasterize_plate(lx, ly, ok, owned, offgrid, seed % 6, *t)
        tables.append((wrote, t))
    assert tables[0][0] == tables[1][0]
    for a, b in zip(tables[0][1], tables[1][1]):
        np.testing.assert_array_equal(a, b)


def test_numpy_fallbacks_equal_both(monkeypatch):
    """With no library every entry point returns None, and the io modules'
    NumPy paths give the bytes the native paths give."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (21, 17, 3), np.uint8)
    frames = rng.integers(0, 256, (12, 9, 3), np.uint8)
    pal = palette.default_palette()
    scan = _filtered_scan(12, 17, 3, seed=9)
    native_out = (png.decode_png(png.encode_png(img)), gif.encode_gif(frames, pal),
                  native.png_unfilter(scan, 3))
    monkeypatch.setattr(native, "_load", lambda: None)
    assert not native.available()
    for call in (lambda: native.palmap_build(pal), lambda: native.pack_batch(frames[None]),
                 lambda: native.gif_lzw_encode(frames, 8), lambda: native.png_unfilter(scan, 3),
                 lambda: native.libm_unary(0, np.zeros(3))):
        assert call() is None
    assert gif.encode_gif(frames, pal) == native_out[1] == jgif.encode_gif(frames, pal)
    np.testing.assert_array_equal(png.decode_png(png.encode_png(img)), native_out[0])
    np.testing.assert_array_equal(png._unfilter(scan, 3), native_out[2])
    np.testing.assert_array_equal(palette.create_palmap(pal), jpalette.create_palmap(pal))
    from blinky_tpu_torch.io.cubemap import from_batch_layout, to_batch_layout

    fr = rng.integers(0, 256, (3, 6, 5, 5), np.uint8)
    np.testing.assert_array_equal(from_batch_layout(to_batch_layout(fr)), fr)


_AUDIT = textwrap.dedent("""
    import sys
    from pathlib import Path

    jax_pkg = str(Path(sys.argv[1]) / "blinky_tpu") + "/"
    seen = []

    def hook(event, args):
        if event in ("open", "ctypes.dlopen", "os.listdir", "os.scandir") and args:
            path = args[0]
            if isinstance(path, (str, bytes, Path)):
                p = str(Path(path.decode() if isinstance(path, bytes) else path).resolve())
                if p.startswith(jax_pkg) or p + "/" == jax_pkg:
                    seen.append((event, p))

    sys.addaudithook(hook)
    import numpy as np
    from blinky_tpu_torch import native, palette, xmath
    from blinky_tpu_torch.io import cubemap, dataset, demfile, gif, pak, png, ppm
    from blinky_tpu_torch.utils import timing
    assert native.available()
    pal = palette.default_palette()
    palette.create_palmap(pal)
    xmath.sin(np.linspace(0, 1, 5))
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    png.decode_png(png.encode_png(img))
    gif.decode_gif(gif.encode_gif(img, pal))
    cubemap.from_batch_layout(cubemap.to_batch_layout(np.zeros((2, 6, 4, 4), np.uint8)))
    assert not seen, seen
    print("clean")
""")


def test_port_opens_nothing_under_blinky_tpu():
    """An audit hook in a fresh interpreter sees every file open and every
    library load while the port's native library loads and its codecs run:
    none is under blinky_tpu/.  The source files say so too."""
    proc = subprocess.run([sys.executable, "-c", _AUDIT, str(REPO)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"
    for p in (REPO / "blinky_tpu_torch").rglob("*.py"):
        text = p.read_text()
        assert '"blinky_tpu"' not in text and "'blinky_tpu'" not in text, p


_BUILDER = textwrap.dedent("""
    import ctypes, sys
    from pathlib import Path
    import numpy as np
    from blinky_tpu_torch import native, palette

    lib_path = Path(sys.argv[1])
    assert native.build_library(native.SOURCE, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    native.bind(lib)
    pal = np.ascontiguousarray(palette.default_palette())
    out = np.empty((6, 256), np.uint8)
    lib.palmap_build(native._u8(pal), native._u8(out))
    sys.stdout.write(out.tobytes().hex())
""")


def test_two_processes_building_at_once_load_a_whole_library(tmp_path):
    """Two interpreters build the same stale library at the same moment:
    the lock lets one compile, the rename shows the other only a whole
    file, and both bind and run it."""
    lib_path = tmp_path / "build" / "libblinky_native.so"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(lib_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert bytes.fromhex(out) == jnative.palmap_build(palette.default_palette()).tobytes()
    assert sorted(q.name for q in lib_path.parent.iterdir()) == [
        "libblinky_native.so", "libblinky_native.so.lock"]  # no temporary left
    assert lib_path.read_bytes() == native.LIBRARY.read_bytes()


@pytest.mark.parametrize("outcome", ["built", "failed", "up to date", "raised"])
def test_compile_locked_replaces_the_library_only_with_a_whole_build(tmp_path, outcome):
    """The one build routine of the CUDA kernels and the native library: a
    compiler that succeeds has its output renamed onto the library, one that
    fails or cannot start leaves the old library and no temporary, and a
    library newer than its sources is not rebuilt."""
    from blinky_tpu_torch.kernels._build import compile_locked

    dep, library = tmp_path / "a.cpp", tmp_path / "build" / "liba.so"
    dep.write_text("source")
    library.parent.mkdir()
    library.write_text("old")
    os.utime(library, (1, 1))  # older than the source
    if outcome == "up to date":
        os.utime(library, None)
        os.utime(dep, (1, 1))
    code = {"built": "open(sys.argv[1], 'w').write('new')",
            "failed": "open(sys.argv[1], 'w').write('half'); sys.exit(3)"}.get(outcome, "")

    def command(tmp):
        if outcome == "raised":
            raise OSError("no compiler")
        return [sys.executable, "-c", f"import sys; {code}", str(tmp)]

    if outcome == "raised":
        with pytest.raises(OSError):
            compile_locked(library, [dep], command)
    else:
        proc = compile_locked(library, [dep], command)
        if outcome == "up to date":
            assert proc is None
        else:
            assert proc.returncode == (0 if outcome == "built" else 3) and proc.seconds > 0
    assert library.read_text() == ("new" if outcome == "built" else "old")
    assert sorted(q.name for q in library.parent.iterdir()) == [
        "liba.so", "liba.so.lock"]
