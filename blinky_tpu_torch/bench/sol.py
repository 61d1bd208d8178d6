"""Speed-of-light probes: the port of :mod:`blinky_tpu.bench.sol`'s two
Pallas probes, as hand-written CUDA kernels (``csrc/sol.cu``).

* :func:`onehot_gather` (K3): the row gather written as a one-hot matrix
  product, per window ``onehot(idx[w]) [T, R] @ src[w] [R, B]`` with 8-bit
  operands and int32 sums, on the tensor cores -- the formulation
  ``blinky_tpu`` measured against the direct gather, kept as a probe of the
  same idea against K1 here.
* :func:`stream_read` (K4): the sum of a ``[rows, 1024]`` u8 array into one
  wrapping int32 -- the card's streaming read rate.
* :func:`mxu_matmul`: the XLA probe of the same name, the card's int8 and
  bf16 matrix-product rate at the one-hot gather's shapes -- K3's
  yardstick.  It is a plain product (``torch._int_mm``, ``torch.matmul``),
  as the JAX package leaves it to XLA, not one of the port's kernels.

* :func:`stream_copy`, :func:`row_gather`, :func:`element_gather`: the other
  XLA probes, the card's read+write rate and its row and element gather
  rates -- the yardsticks K1, K5 and K10 are judged against.  Plain torch
  calls too (``x + s``, ``index_select``, ``take``), for the same reason.

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors.  :func:`run_sol` times the probes at the JAX
package's full-size shapes (``sol.py:299-310``) with CUDA events; it needs a
card.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch.kernels import _build


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn()`` on the current CUDA device: CUDA
    events around *iters* calls after *warmup* calls.  Raises without a
    card."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------ one-hot gather


def onehot_gather_plain(idx, src):
    """K3's plain version, by advanced indexing: ``out[w, t] = src[w,
    idx[w, t]]``, and 0 where ``idx`` is outside [0, R) (its one-hot row is
    empty).  The int8 product wraps back to the source byte, so every u8
    value gathers exactly."""
    W, R = src.shape[0], src.shape[1]
    idx = idx.long()
    ok = (idx >= 0) & (idx < R)
    w = torch.arange(W, device=src.device)[:, None]
    rows = src[w, idx.clamp(0, R - 1)]
    return torch.where(ok[..., None], rows, 0)


def onehot_gather(idx, src):
    """K3: ``idx`` [W, T] int32 (row within window), ``src`` [W, R, B] u8
    -> [W, T, B] u8 (``blinky_tpu``'s ``pallas_onehot_gather_call``)."""
    k = "onehot_gather"
    if src.dtype != torch.uint8 or src.dim() != 3 or not src.is_contiguous():
        raise ValueError(f"{k}: src must be a contiguous [W, R, B] u8 tensor, "
                         f"got {src.dtype} {tuple(src.shape)}")
    W, R, B = src.shape
    if (idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != W
            or not idx.is_contiguous() or idx.device != src.device):
        raise ValueError(f"{k}: idx must be a contiguous [{W}, T] int32 tensor "
                         f"on {src.device}, got {idx.dtype} {tuple(idx.shape)} "
                         f"on {idx.device}")
    if not _build.on_card(k, src.device):
        return onehot_gather_plain(idx, src)
    T = idx.shape[1]
    with _build.on_device(src.device) as stream:
        out = torch.empty((W, T, B), dtype=torch.uint8, device=src.device)
        if out.numel():
            _build.launch(onehot_gather, k, "blinky_onehot_gather",
                idx.data_ptr(), src.data_ptr(), W, T, R, B, out.data_ptr(), stream)
    return out


onehot_gather.launches = 0


# -------------------------------------------------------------- stream read


def stream_read_plain(x):
    """K4's plain version: a 64-bit sum wrapped to int32 -> [1, 1]."""
    s = x.sum(dtype=torch.int64)
    return ((s + 2**31) % 2**32 - 2**31).to(torch.int32).reshape(1, 1)


def stream_read(x):
    """K4: the sum of ``x`` [rows, 1024] u8 into one int32 that wraps in
    two's complement -> [1, 1] int32 (``blinky_tpu``'s
    ``_stream_read_kernel``)."""
    k = "stream_read"
    if (x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != 1024
            or not x.is_contiguous()):
        raise ValueError(f"{k}: x must be a contiguous [rows, 1024] u8 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not _build.on_card(k, x.device):
        return stream_read_plain(x)
    if x.data_ptr() % 16:
        raise ValueError(f"{k}: x must be 16-byte aligned")
    with _build.on_device(x.device) as stream:
        out = torch.empty((1, 1), dtype=torch.int32, device=x.device)
        _build.launch(stream_read, k, "blinky_stream_read",
            x.data_ptr(), x.numel(), out.data_ptr(), stream)
    return out


stream_read.launches = 0


# ------------------------------------------------------------------- probes


def full_screen_ms(ms: float, windows: int, t_rows: int,
                   screen_pixels: int = 1920 * 1080) -> float:
    """The time of *windows* windows of *t_rows* indices, extrapolated to a
    whole screen of *screen_pixels* indices, as
    ``blinky_tpu/bench/sol.py:214-218`` does (there rounded to 0.1 ms)."""
    return ms * -(-screen_pixels // t_rows) / windows


def onehot_probe(device="cuda", windows: int = 64, t_rows: int = 384,
                 r_rows: int = 2048, row_bytes: int = 1024,
                 iters: int = 20, src_hi: int = 128) -> dict:
    """Time K3 and its plain version at the full-size probe shape
    (``blinky_tpu/bench/sol.py:307``), and check that they agree.  Source
    bytes are drawn from [0, *src_hi*): 128 is the JAX probe's int8-safe
    range, 256 every u8 value."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(
        rng.integers(0, r_rows, (windows, t_rows)).astype(np.int32)).to(device)
    src = torch.from_numpy(rng.integers(
        0, src_hi, (windows, r_rows, row_bytes)).astype(np.uint8)).to(device)
    out = onehot_gather(idx, src)
    ms = cuda_ms(lambda: onehot_gather(idx, src), iters)
    plain = onehot_gather_plain(idx, src)
    plain_ms = cuda_ms(lambda: onehot_gather_plain(idx, src), iters)
    # the library call for the same function: every index is in range here
    rows = idx.long()[:, :, None].expand(-1, -1, row_bytes)
    library_equal = bool(torch.equal(torch.gather(src, 1, rows), out))
    library_ms = cuda_ms(lambda: torch.gather(src, 1, rows), iters)
    # the product's multiply-adds, and the least bytes of the function: a
    # gather reads each distinct row that idx names once, not all of src
    macs = float(windows) * t_rows * r_rows * row_bytes
    rows_read = int(torch.unique(idx.long() + r_rows * torch.arange(
        windows, device=device)[:, None]).numel())
    nbytes = rows_read * row_bytes + windows * t_rows * (row_bytes + 4)
    return dict(probe="onehot_gather", windows=windows, T=t_rows, R=r_rows,
                B=row_bytes, src_hi=src_hi, iters=iters, ms=ms, plain_ms=plain_ms,
                macs=macs, bytes=nbytes,
                tmacs=macs / (ms * 1e-3) / 1e12, gbps=nbytes / (ms * 1e-3) / 1e9,
                ns_per_index=ms * 1e6 / (windows * t_rows),
                full_screen_ms=full_screen_ms(ms, windows, t_rows),
                max_abs_err=int((out.int() - plain.int()).abs().max()),
                equal=bool(torch.equal(out, plain)),
                library="torch.gather(src, 1, idx[..., None].expand(W, T, B))",
                library_ms=library_ms, library_equal=library_equal)


def stream_read_probe(device="cuda", nbytes: int = 1 << 30, iters: int = 10) -> dict:
    """Time K4 and its plain version over *nbytes* (1 GiB in
    ``blinky_tpu/bench/sol.py:310``), and check that they agree."""
    device = torch.device(device)
    rows = max(nbytes // 1024, 1)
    # a deterministic pattern whose sum wraps int32 many times over
    x = ((torch.arange(rows, device=device) % 251).to(torch.uint8)[:, None]
         + (torch.arange(1024, device=device) * 3 % 256).to(torch.uint8)[None, :])
    out = stream_read(x)
    ms = cuda_ms(lambda: stream_read(x), iters)
    plain = stream_read_plain(x)
    plain_ms = cuda_ms(lambda: stream_read_plain(x), iters)
    # the library call: an int32 sum if it wraps as K4's does, else int64
    dtype = torch.int32
    if not torch.equal(x.sum(dtype=dtype).reshape(1, 1), out):
        dtype = torch.int64
    library_ms = cuda_ms(lambda: x.sum(dtype=dtype), iters)
    return dict(probe="stream_read", bytes=rows * 1024, iters=iters, ms=ms,
                plain_ms=plain_ms, gbps=rows * 1024 / (ms * 1e-3) / 1e9,
                plain_gbps=rows * 1024 / (plain_ms * 1e-3) / 1e9,
                max_abs_err=abs(int(out.item()) - int(plain.item())),
                equal=bool(torch.equal(out, plain)),
                library=f"x.sum(dtype={dtype})", library_ms=library_ms)


# ------------------------------------------------------------ matmul rate


def matmul_product(a, b):
    """The product :func:`mxu_matmul` times: int8 with int32 sums through
    ``torch._int_mm``, bf16 through ``torch.matmul``."""
    if a.dtype == torch.int8:
        return torch._int_mm(a, b)
    return torch.matmul(a, b)


def mxu_matmul(device="cuda", m: int = 384, k: int = 2048, n: int = 1024,
               dtype: str = "int8", iters: int = 50) -> dict:
    """The card's multiply-add rate at the one-hot gather's shapes
    (``blinky_tpu/bench/sol.py:118``, full size at ``:305-306``): ``[m, k]
    @ [k, n]`` of ones in int8 (int32 sums) or bf16."""
    device = torch.device(device)
    dt = torch.int8 if dtype == "int8" else torch.bfloat16
    a = torch.ones((m, k), dtype=dt, device=device)
    b = torch.ones((n, k), dtype=dt, device=device).t()  # column-major, as cuBLASLt's int8 takes it
    ms = cuda_ms(lambda: matmul_product(a, b), iters)
    return dict(probe="mxu_matmul", m=m, k=k, n=n, dtype=dtype, iters=iters,
                ms=ms, tmacs=float(m) * k * n / (ms * 1e-3) / 1e12)


# ------------------------------------------------- copy and gather rates


def stream_copy(device="cuda", nbytes: int = 1 << 30, iters: int = 8) -> dict:
    """The card's streaming rate: read and write *nbytes* a call
    (``blinky_tpu/bench/sol.py:55``; 1 GiB at ``:299``), as ``x + 1`` on a
    ``[n, 1024]`` u8 array.  ``gbps`` counts both directions."""
    n = max(nbytes // 1024, 8)
    x = torch.zeros((n, 1024), dtype=torch.uint8, device=torch.device(device))
    ms = cuda_ms(lambda: x + 1, iters)
    return dict(probe="stream_copy", bytes=n * 1024, iters=iters, ms=ms,
                gbps=2.0 * n * 1024 / (ms * 1e-3) / 1e9)


def gather_probe_indices(n_idx: int, rows: int, device="cuda"):
    """The scattered indices of the JAX gather probes
    (``blinky_tpu/bench/sol.py:79``): ``arange(n) * 7919 % rows`` in int32,
    where the product wraps and ``%`` is a floor modulo."""
    return torch.arange(n_idx, dtype=torch.int32, device=torch.device(device)) * 7919 % rows


def _gather_probe(name, src_shape, n_idx, iters, row: bool, device) -> dict:
    """Shared body of the row and element gather probes
    (``blinky_tpu/bench/sol.py:75``)."""
    R = src_shape[0]
    src = torch.zeros(src_shape, dtype=torch.uint8, device=torch.device(device))
    idx = gather_probe_indices(n_idx, R, device)
    if row:
        ms = cuda_ms(lambda: src.index_select(0, idx), iters)
    else:
        idx = idx.long()  # torch.take wants int64 indices; made outside the timing
        ms = cuda_ms(lambda: torch.take(src, idx), iters)
    row_bytes = int(np.prod(src_shape[1:])) if row else 1
    return dict(probe=name, rows=R, n_idx=n_idx, row_bytes=row_bytes, iters=iters,
                ms=ms, ns_per_index=ms * 1e6 / n_idx,
                gbps=n_idx * row_bytes * 2 / (ms * 1e-3) / 1e9)


def row_gather(device="cuda", n_rows: int = 6 * 1080 * 1080, row_bytes: int = 1024,
               n_idx: int = 1920 * 1080, iters: int = 4) -> dict:
    """The remap's primitive as one library call: *n_idx* scattered rows of
    *row_bytes* (the batch lanes) out of *n_rows*, ``src.index_select(0,
    idx)`` (``blinky_tpu/bench/sol.py:103``; full size at ``:300-303``)."""
    return _gather_probe("row_gather", (n_rows, row_bytes), n_idx, iters, True, device)


def element_gather(device="cuda", n_elems: int = 1 << 24, n_idx: int = 1 << 23,
                   iters: int = 4) -> dict:
    """Independent u8 element gathers, ``torch.take(src, idx)``: the
    per-frame-pose floor, with nothing to amortise an index over
    (``blinky_tpu/bench/sol.py:111``; full size at ``:304``)."""
    return _gather_probe("element_gather", (n_elems,), n_idx, iters, False, device)


def run_sol(device="cuda") -> list:
    """The probes at their full-size shapes, on a card: the copy rate, the
    row gather at 1024 and 128 lanes and the element gather (plain torch
    calls), K3 with the JAX probe's source values and with every u8 value,
    K4, and the int8 and bf16 matrix-product rates."""
    return [stream_copy(device), row_gather(device, row_bytes=1024),
            row_gather(device, row_bytes=128), element_gather(device),
            onehot_probe(device), onehot_probe(device, src_hi=256),
            stream_read_probe(device), mxu_matmul(device, dtype="int8"),
            mxu_matmul(device, dtype="bf16")]
