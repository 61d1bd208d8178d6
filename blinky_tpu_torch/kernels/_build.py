"""Build and bind the hand-written CUDA kernels (``blinky_tpu_torch/csrc``).

At first use :func:`library` compiles every ``csrc/*.cu`` with ``nvcc`` for
Hopper into ``blinky_tpu_torch/build/libblinky_torch_kernels.so`` and loads
it with ``ctypes``.  The library has a plain ``extern "C"`` interface and
includes none of PyTorch's headers, so the build takes seconds.  It is
rebuilt when a source is newer than the library, and the build is
serialised under a lock, between threads and between processes.

There is no fallback: without ``nvcc`` or with a failing build,
:func:`library` raises.  Only the kernel wrappers call it, and only for
tensors on a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading
import time
from pathlib import Path

from blinky_tpu_torch.utils.timing import span

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIBRARY = BUILD_DIR / "libblinky_torch_kernels.so"

# route (b) of building a kernel by hand: nvcc into a shared library with a
# plain C interface; -Xptxas=-v reports registers, shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the sources compile side by side, as many at once as the host has cores
NVCC_PARALLEL = ["--threads", "0"]

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_f = ctypes.c_float
# every entry point returns cudaGetLastError() after its launch
_SIGNATURES = {
    # src, rows, elem_bytes, batch, idx, valid, bg, tint_rgb, tint_mask,
    # fill, npix, out, stream
    "blinky_remap_gather": [_vp, _ll, _i, _i, _vp, _vp, _vp, _vp, _vp, _i,
                            _ll, _vp, _vp],
    # the same arguments: K1's ring path
    "blinky_remap_gather_ring": [_vp, _ll, _i, _i, _vp, _vp, _vp, _vp, _vp, _i,
                                 _ll, _vp, _vp],
    # src, rows, batch, idx, valid, tint, bg, tint_lut, rgb_lut, fill, npix,
    # out, stream
    "blinky_remap_lut": [_vp, _ll, _i, _vp, _vp, _vp, _vp, _vp, _vp, _i, _ll,
                         _vp, _vp],
    # idx, src, W, T, R, B, out, stream
    "blinky_onehot_gather": [_vp, _vp, _i, _i, _i, _i, _vp, _vp],
    # x, nbytes, out, stream
    "blinky_stream_read": [_vp, _ll, _vp, _vp],
    # src, N, elem_bytes, batch, idx, valid, bg, k, hb, wb, out, stream
    "blinky_posed_gather": [_vp, _ll, _i, _i, _vp, _vp, _vp, _i, _i, _i, _vp, _vp],
    # vx, vy, vz, lens_valid, hb, wb, bases, batch, plates (host), nplates,
    # resolver, fast_dist, fast_half, given, grid_lines, S, expanded, src, N,
    # elem_bytes, bg, k, out, stream
    "blinky_static_ray_posed": [_vp, _vp, _vp, _vp, _i, _i, _vp, _i, _vp, _i, _i,
                                _f, _f, _vp, _vp, _i, _i, _vp, _ll, _i, _vp, _i, _vp, _vp],
    # in, ld, T, batch, elem_bytes, n_out, out, stream
    "blinky_posed_layout": [_vp, _ll, _ll, _i, _i, _ll, _vp, _vp],
    # the same arguments: K7's long-row path
    "blinky_posed_layout_rows": [_vp, _ll, _ll, _i, _i, _ll, _vp, _vp],
    # in, sp, sy, sx, sb, P, S, batch, elem_bytes, n_out, out, stream
    "blinky_posed_layout_strided": [_vp, _ll, _ll, _ll, _ll, _i, _i, _i, _i, _ll, _vp, _vp],
    # vx, vy, vz, lens_valid, npix, basis (host), plates (host), nplates,
    # resolver, fast_dist, fast_half, given, grid_lines, S, plate, px, py,
    # valid, tint, flat_idx, used, stream
    "blinky_lensmap_resolve": [_vp, _vp, _vp, _vp, _ll, _vp, _vp, _i, _i, _f, _f, _vp, _vp,
                               _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    # vx, vy, vz, npix, bases, batch, ox, oy, oz, stream
    "blinky_rotate_rays": [_vp, _vp, _vp, _ll, _vp, _i, _vp, _vp, _vp, _vp],
    # vx, vy, vz, lens_valid, npix, steps, plates (host), nplates, resolver,
    # fast_dist, fast_half, given, grid_lines, S, expanded, src, N,
    # elem_bytes, bg, out, stream
    "blinky_sweep_remap": [_vp, _vp, _vp, _vp, _ll, _i, _vp, _i, _i, _f, _f, _vp, _vp, _i,
                           _i, _vp, _ll, _i, _vp, _vp, _vp],
    # src, rows, batch, idx, w, taps, n, plate_mask, valid, bg, tint_rgb,
    # tint_mask, out, stream
    "blinky_equirect_gather": [_vp, _ll, _i, _vp, _vp, _i, _ll, _vp, _vp, _vp, _vp, _vp,
                               _vp, _vp],
    # the same arguments: K10's ring path
    "blinky_equirect_gather_ring": [_vp, _ll, _i, _vp, _vp, _i, _ll, _vp, _vp, _vp, _vp, _vp,
                                    _vp, _vp],
    # in, k, H, W, batch, out, stream
    "blinky_downsample_rgba": [_vp, _i, _ll, _ll, _i, _vp, _vp],
    # in, planes, per_plane, tints (host), out, stream
    "blinky_tint_expand_rgba": [_vp, _i, _ll, _vp, _vp, _vp],
}

_lock = threading.Lock()
_lib = None
# what the last build in this process did: seconds and nvcc's output
# (None when the library was up to date and only loaded)
last_build: dict | None = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def compile_locked(library: Path, deps, command, timeout=None):
    """Build *library* unless it is newer than every file of *deps*.

    ``command(tmp)`` gives the compiler's argument list, writing to a
    temporary name beside the library; that file replaces the library only
    when the compiler succeeds, so no process ever loads a half-written
    library.  Threads and processes are serialised by an ``fcntl`` lock on
    ``<library>.lock``.  Returns None when the library was up to date, else
    the compiler's ``CompletedProcess`` (text output) with its wall-clock
    ``seconds``; errors of the run itself (``OSError``, a timeout) propagate.
    """
    library.parent.mkdir(parents=True, exist_ok=True)
    with open(library.with_name(library.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building
        if library.exists() and all(Path(d).stat().st_mtime <= library.stat().st_mtime
                                    for d in deps):
            return None
        tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(command(tmp), capture_output=True, text=True,
                                  timeout=timeout)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise
        proc.seconds = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, library)  # loaders never see a half-written library
        else:
            tmp.unlink(missing_ok=True)
        return proc


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(
            f"nvcc not found at {nvcc}: the CUDA kernels of blinky_tpu_torch "
            "build only where the CUDA toolkit is installed")
    return str(nvcc)


def _build() -> None:
    global last_build
    proc = compile_locked(
        LIBRARY, list(CSRC.iterdir()),
        lambda tmp: [_nvcc(), *NVCC_FLAGS, *NVCC_PARALLEL, "-o", str(tmp),
                     *map(str, sources())])
    if proc is None:
        return
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(map(str, proc.args))}\n"
            f"{proc.stdout}{proc.stderr}")
    last_build = {"seconds": proc.seconds, "log": proc.stdout + proc.stderr}


def library():
    """The kernel library, built if stale and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            with span("build.kernel_library"):
                _build()
                lib = ctypes.CDLL(str(LIBRARY))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                lib.blinky_error_string.argtypes = [ctypes.c_int]
                lib.blinky_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(wrapper, name: str, entry: str, *args, lib=None) -> None:
    """Launch one kernel for *wrapper*, a kernel's wrapper function: call
    the entry point *entry* of *lib* (by default the kernel library) with
    *args*, check its code, and count the launch in ``wrapper.launches``.

    The call runs inside the span ``launch.<name>`` (*name*: the kernel's
    name in the bench suite's kernels line).  The caller has evaluated
    *args* before, so the span holds the ctypes call alone: the conversion
    of the arguments, the entry point's own host work and the CUDA launch,
    any wait for a free slot in the card's launch queue included."""
    fn = getattr(library() if lib is None else lib, entry)
    with span(f"launch.{name}"):
        rc = fn(*args)
    check(rc, wrapper.__name__)
    wrapper.launches += 1


def check(rc: int, kernel: str) -> None:
    """Raise if an entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().blinky_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch: {msg}")


def on_card(kernel: str, device) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device has neither, and raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {device}")


def ptr(t):
    """A tensor's device address for a ``c_void_p`` argument (None = null)."""
    return None if t is None else t.data_ptr()


@contextlib.contextmanager
def on_device(device):
    """Make *device* the current CUDA device for a wrapper's allocations and
    launch, and yield the raw handle of PyTorch's current stream there.

    The CUDA runtime launches into the current device's context, and refuses
    a stream of another device; attributes a launch sets or reads (K3's
    shared-memory limit, the SM count of a block-stride grid) apply to the
    current device too.  So every wrapper allocates and launches inside
    this block, whichever card is current in the caller."""
    import torch

    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream
