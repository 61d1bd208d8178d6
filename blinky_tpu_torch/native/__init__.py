"""ctypes bindings for the native host runtime (with pure-Python fallback).

The port builds its own copy of the native library: at first use,
``native/src/blinky_native.cpp`` is compiled with the flags of the JAX
package's Makefile (``blinky_tpu/native/Makefile``) into
``blinky_tpu_torch/build/libblinky_native.so``, and rebuilt whenever the
source is newer.  The same source and flags give the same machine code, so
the f64 lens math (glibc libm loops, :mod:`blinky_tpu_torch.xmath`),
``create_palmap``'s ``palmap_build`` and the forward quad fill compute the
JAX package's bits.  The build is the CUDA kernels' routine
(:func:`blinky_tpu_torch.kernels._build.compile_locked`): serialised between
threads and between processes under an ``fcntl`` lock and written under a
temporary name, then renamed, so no process ever loads a half-written
library.

Every entry point returns None when the library is unavailable (no C++
compiler, or a failing build), and the callers take the NumPy
implementations, as in :mod:`blinky_tpu.native`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from blinky_tpu_torch.utils.timing import span

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().parent / "src" / "blinky_native.cpp"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libblinky_native.so"
# blinky_tpu/native/Makefile's CXXFLAGS: -ffp-contract=off keeps the forward
# rasterizer's scanline interpolation bit-equal to the Python fallback (no FMA
# contraction), and -march=x86-64-v2 runs on any host of that baseline
CXXFLAGS = ["-O3", "-march=x86-64-v2", "-ffp-contract=off", "-fPIC", "-shared",
            "-std=c++17", "-pthread"]

_lib = None
_tried = False
_load_lock = threading.Lock()


def build_library(source: Path = SOURCE, library: Path = LIBRARY) -> bool:
    """Compile *source* into *library* unless the library is newer than the
    source.  Returns True when a library is in place (built now or before),
    False when the compiler is missing or fails and there is none."""
    from blinky_tpu_torch.kernels._build import compile_locked

    try:
        proc = compile_locked(
            library, [source],
            lambda tmp: [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
                         str(source)],
            timeout=120)
    except (OSError, subprocess.SubprocessError):
        return library.exists()
    return proc is None or proc.returncode == 0 or library.exists()


def _load():
    # the lock serializes the first load between host threads; _tried is
    # published last so the unlocked fast path never sees a half-done load
    global _lib, _tried
    if _tried:
        return _lib
    with _load_lock:
        if not _tried:
            with span("build.native_library"):
                _lib = _build_and_bind()
            _tried = True
    return _lib


def _build_and_bind():
    if not build_library():
        return None
    try:
        lib = ctypes.CDLL(str(LIBRARY))
    except OSError:
        return None
    try:
        bind(lib)
    except AttributeError:
        return None  # a library missing newer symbols -> Python fallbacks
    return lib


def bind(lib) -> None:
    """Set the argument and result types of every entry point of *lib*."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pal_nearest.restype = ctypes.c_int
    lib.pal_nearest.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.palmap_build.argtypes = [u8p, u8p]
    lib.pcx_encode_body_ref.restype = ctypes.c_long
    lib.pcx_encode_body_ref.argtypes = [u8p, ctypes.c_long, u8p]
    lib.pcx_encode_body_rle.restype = ctypes.c_long
    lib.pcx_encode_body_rle.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.pcx_decode_body.restype = ctypes.c_int
    lib.pcx_decode_body.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long]
    lib.pcx_decode_body_many.restype = ctypes.c_int
    lib.pcx_decode_body_many.argtypes = [
        ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        u8p, ctypes.c_long, ctypes.c_int,
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.forward_rasterize_plate.restype = ctypes.c_int
    lib.forward_rasterize_plate.argtypes = [
        i32p, i32p, u8p, u8p, u8p,
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        i32p, i32p, i32p, u8p,
    ]
    lib.pack_batch.argtypes = [u8p, u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long]
    lib.unpack_batch.argtypes = [u8p, u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long]
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.libm_unary.argtypes = [ctypes.c_int, f64p, f64p, ctypes.c_long]
    lib.libm_binary.argtypes = [ctypes.c_int, f64p, f64p, f64p, ctypes.c_long]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_long, ctypes.c_long,
                                 ctypes.c_int]
    lib.gif_lzw_encode.restype = ctypes.c_long
    lib.gif_lzw_encode.argtypes = [u8p, ctypes.c_long, ctypes.c_int,
                                   u8p, ctypes.c_long]
    lib.gif_lzw_decode.restype = ctypes.c_long
    lib.gif_lzw_decode.argtypes = [u8p, ctypes.c_long, ctypes.c_int,
                                   u8p, ctypes.c_long]


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def palmap_build(pal: np.ndarray):
    """Native create_palmap; returns None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pal = np.ascontiguousarray(pal, dtype=np.uint8)
    out = np.empty((6, 256), dtype=np.uint8)
    lib.palmap_build(_u8(pal), _u8(out))
    return out


def pcx_decode_body(body: bytes, total: int):
    lib = _load()
    if lib is None:
        return None
    data = np.frombuffer(body, dtype=np.uint8)
    out = np.empty(total, dtype=np.uint8)
    rc = lib.pcx_decode_body(_u8(data), len(data), _u8(out), total)
    if rc != 0:
        raise ValueError("truncated PCX body")
    return out


def pcx_encode_body(img: np.ndarray, mode: str = "reference"):
    lib = _load()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    out = np.empty(2 * h * w + 16, dtype=np.uint8)
    if mode == "reference":
        n = lib.pcx_encode_body_ref(_u8(img), img.size, _u8(out))
    else:
        n = lib.pcx_encode_body_rle(_u8(img), w, h, _u8(out))
    return out[:n].tobytes()


def pcx_decode_body_many(bodies: list, total: int, nthreads: int | None = None):
    """Decode many equal-size PCX bodies in parallel -> [count, total] u8."""
    lib = _load()
    if lib is None:
        return None
    arrs = [np.frombuffer(b, dtype=np.uint8) for b in bodies]
    count = len(arrs)
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * count)(*[_u8(a) for a in arrs])
    lens = (ctypes.c_long * count)(*[len(a) for a in arrs])
    out = np.empty((count, total), dtype=np.uint8)
    nt = nthreads or min(8, os.cpu_count() or 1)
    rc = lib.pcx_decode_body_many(ptrs, lens, count, _u8(out), total, nt)
    if rc != 0:
        raise ValueError("truncated PCX body in batch")
    return out


def forward_rasterize_plate(lx, ly, ok, owned, offgrid, plate,
                            plate_a, px_a, py_a, tint_a):
    """Native quad rasterizer for one plate (draw_quad scan-order
    transcription); mutates plate_a/px_a/py_a/tint_a in place.  *offgrid*
    is the [S, S] not-on-rubix-grid texel mask (tint is only written for
    off-grid texels — set_lensmap_grid, fisheye.c:1955-1958).  Returns
    True if any pixel was written, None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    S = owned.shape[0]
    H, W = plate_a.shape
    lx = np.ascontiguousarray(lx, dtype=np.int32)
    ly = np.ascontiguousarray(ly, dtype=np.int32)
    ok = np.ascontiguousarray(ok, dtype=np.uint8)
    owned = np.ascontiguousarray(owned, dtype=np.uint8)
    offgrid = np.ascontiguousarray(offgrid, dtype=np.uint8)
    # the C loop trusts these shapes: corners [S+1, S+1], texels [S, S], and
    # the tables it writes in place [H, W], C-contiguous, of their dtypes
    for a, shape in ((lx, (S + 1, S + 1)), (ly, (S + 1, S + 1)), (ok, (S + 1, S + 1)),
                     (owned, (S, S)), (offgrid, (S, S))):
        if a.shape != shape:
            raise ValueError(f"forward_rasterize_plate: {a.shape} where {shape} is needed")
    for a, dtype in ((plate_a, np.int32), (px_a, np.int32), (py_a, np.int32),
                     (tint_a, np.uint8)):
        if a.shape != (H, W) or a.dtype != dtype or not a.flags.c_contiguous:
            raise ValueError("forward_rasterize_plate: the tables must be C-contiguous "
                             f"[{H}, {W}] arrays, int32 (uint8 for the tint)")

    def _i32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    wrote = lib.forward_rasterize_plate(
        _i32(lx), _i32(ly), _u8(ok), _u8(owned), _u8(offgrid), S, W, H, plate,
        _i32(plate_a), _i32(px_a), _i32(py_a), _u8(tint_a),
    )
    return bool(wrote)


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64_contig(x) -> np.ndarray:
    """float64 C-contiguous view/copy preserving ndim (ascontiguousarray
    would promote 0-d to 1-d)."""
    a = np.asarray(x, dtype=np.float64)
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def libm_unary(op: int, x: np.ndarray):
    """Elementwise glibc libm (bit-identical to the Lua VM's math.*);
    returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = _f64_contig(x)
    out = np.empty_like(x)
    lib.libm_unary(op, _f64(x), _f64(out), x.size)
    return out


def libm_binary(op: int, a: np.ndarray, b: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    a = _f64_contig(a)
    b = _f64_contig(b)
    if a.size != b.size:
        # the C loop reads b[0..a.size): a smaller b would be an
        # out-of-bounds read (callers must broadcast first, xmath.py)
        a, b = (np.ascontiguousarray(x) for x in np.broadcast_arrays(a, b))
    out = np.empty_like(a)
    lib.libm_binary(op, _f64(a), _f64(b), _f64(out), a.size)
    return out


def pack_batch(frames_bpss: np.ndarray):
    """[B, P, S, S] -> [P, S, S, B]; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(frames_bpss, dtype=np.uint8)
    B, P, S, S2 = src.shape
    if S != S2:
        raise ValueError(f"plates must be square, got {S}x{S2}")
    dst = np.empty((P, S, S, B), dtype=np.uint8)
    lib.pack_batch(_u8(src), _u8(dst), B, P, S)
    return dst


def unpack_batch(frames_pssb: np.ndarray):
    """[P, S, S, B] -> [B, P, S, S]; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(frames_pssb, dtype=np.uint8)
    P, S, S2, B = src.shape
    if S != S2:
        raise ValueError(f"plates must be square, got {S}x{S2}")
    dst = np.empty((B, P, S, S), dtype=np.uint8)
    lib.unpack_batch(_u8(src), _u8(dst), B, P, S)
    return dst


def gif_lzw_encode(pixels: np.ndarray, min_code_size: int):
    """Raw GIF LZW codestream for *pixels* (u8, < 2**min_code_size);
    None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    px = np.ascontiguousarray(pixels.reshape(-1), dtype=np.uint8)
    cap = 2 * px.size + 4096
    out = np.empty(cap, dtype=np.uint8)
    n = lib.gif_lzw_encode(_u8(px), px.size, int(min_code_size), _u8(out), cap)
    if n < 0:
        raise ValueError("GIF LZW encode overflow")
    return out[:n].tobytes()


def gif_lzw_decode(stream: bytes, min_code_size: int, total: int):
    """Decode a raw GIF LZW codestream to *total* pixels; None if the
    native lib is unavailable, ValueError on a corrupt stream (the io/
    decoders' error contract)."""
    lib = _load()
    if lib is None:
        return None
    data = np.frombuffer(stream, dtype=np.uint8)
    out = np.empty(max(total, 1), dtype=np.uint8)
    n = lib.gif_lzw_decode(_u8(data), len(data), int(min_code_size),
                           _u8(out), total)
    if n < 0:
        raise ValueError("corrupt GIF LZW stream")
    return out[:n]


def png_unfilter(scan: np.ndarray, channels: int):
    """PNG scanline unfilter: scan [H, 1+W*C] u8 -> [H, W*C] u8; None if
    the native lib is unavailable, ValueError on an unknown filter byte
    (the decoder's error contract)."""
    lib = _load()
    if lib is None:
        return None
    scan = np.ascontiguousarray(scan, dtype=np.uint8)
    h, stride1 = scan.shape
    out = np.empty((h, stride1 - 1), dtype=np.uint8)
    rc = lib.png_unfilter(_u8(scan), _u8(out), h, stride1 - 1,
                          int(channels))
    if rc != 0:
        raise ValueError("unsupported PNG filter")
    return out
