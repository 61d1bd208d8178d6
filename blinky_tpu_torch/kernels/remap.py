"""The per-frame remap: batched gather + tint palette + optional RGB decode.

The port of :mod:`blinky_tpu.kernels.remap`.  Frames keep the JAX package's
batch-innermost layout, ``[MAX_PLATES, S, S, B]``: flattened to ``[R, B]``
rows, each screen pixel's lensmap index selects one row of B contiguous
texels.  The source kinds, the out-of-range rules and the background rules
are the JAX package's, bit for bit.

Two hand-written CUDA kernels do the remap's device work (``csrc/``):

* K1, :func:`remap_gather` (``remap_gather.cu``): the row gather plus the
  background select, with the true-color rubix tint fused after the gather.
  It replaces ``remap_gather_impl`` and ``remap_gather_tint_impl``, and
  ``remap_impl`` when neither of its tables is asked for.
* K2, :func:`remap_lut` (``remap_lut.cu``): the gather with the rubix tint
  LUT and/or the palette -> RGB decode, both tables in shared memory.  It
  replaces ``remap_impl`` and the decode after an expanded gather.

Two more serve the true-colour pipeline (``csrc/resample.cu``):

* K11, :func:`downsample_rgba`: the box resolve of supersampled rendering
  (``Session.render_aa``).  It replaces ``_downsample_rgba``.
* K12, :func:`tint_expand_rgba`: the rubix source expansion of packed-RGBA
  frames that are on the device, behind :func:`expand_frames_tinted_rgba`.
  It replaces that function's ``jnp`` branch.

Each wrapper checks its operands, then runs its plain PyTorch version
(:func:`remap_gather_plain`, :func:`remap_lut_plain`,
:func:`downsample_rgba_plain`, :func:`tint_expand_rgba_plain`) for tensors
on the CPU, or launches its kernel for tensors on a CUDA device.  There is no other
path: a kernel that fails to build or launch raises.

Packed RGBA (``r | g<<8 | b<<16 | a<<24``) travels as ``torch.int32`` bits,
because ``torch.uint32`` is storage-only on the CPU; :class:`RemapKernel`
converts at its boundary (NumPy ``uint32`` or ``torch.uint32`` in and out).
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.palette import MAX_PLATES, create_palmap, rgba_lut
from blinky_tpu_torch.utils.timing import spanned


# ------------------------------------------------------------ plain versions


def _gather_rows(src, idx, fill: bool):
    """``jnp.take(src, idx, axis=0)`` under one of the two rules: clip
    (``mode="clip"``: ``remap_gather_impl``, ``host_remap``) or fill (no
    mode: ``remap_impl``), where an index in [-R, 0) wraps once and any
    other out-of-range index reads all bits set (255 for u8)."""
    rows = src.shape[0]
    idx = idx.long()
    if not fill:
        return src.index_select(0, idx.clamp(0, rows - 1))
    idx = torch.where(idx < 0, idx + rows, idx)
    ok = (idx >= 0) & (idx < rows)
    g = src.index_select(0, torch.where(ok, idx, 0))
    ones = torch.full((), -1 if src.dtype == torch.int32 else 255,
                      dtype=src.dtype, device=src.device)
    return torch.where(ok[:, None], g, ones)


def _tint_rgba(g, tint_rgb, tint_mask):
    """``apply_tint_rgba`` on packed RGBA carried as int32 bits: per channel
    ``c + ((42 * (t - c)) >> 8)`` (an arithmetic shift on int32, as jnp's)
    clipped to 0..255 under the mask, alpha forced to 0xFF where tinted."""
    percent = 256 // MAX_PLATES
    res = None
    for shift in (0, 8, 16):
        c = (g >> shift) & 0xFF
        t = (tint_rgb >> shift) & 0xFF
        c2 = (c + ((percent * (t - c)) >> 8)).clamp(0, 255)
        c = torch.where(tint_mask, c2, c) << shift
        res = c if res is None else res | c
    a = torch.where(tint_mask, 255, (g >> 24) & 0xFF)
    # a << 24 as int32 bits without a signed overflow
    return res | torch.where(a >= 128, a - 256, a) * (1 << 24)


def remap_gather_plain(src, idx, valid, bg, *, fill: bool = False,
                       tint_rgb=None, tint_mask=None):
    """K1's plain version: ``remap_gather_impl`` (clip rule), with the
    post-gather tint of ``remap_gather_tint_impl`` when *tint_rgb* and
    *tint_mask* are given, or ``remap_impl`` without tables (*fill*)."""
    g = _gather_rows(src, idx, fill)
    if tint_rgb is not None:
        g = _tint_rgba(g, tint_rgb[:, None], tint_mask[:, None])
    return torch.where(valid[:, None], g, bg[:, None])


def remap_lut_plain(src, idx, valid, tint, bg, tint_lut=None, rgb_lut=None,
                    *, fill: bool = True):
    """K2's plain version: ``remap_impl`` -- the gather, the rubix LUT
    ``tint_lut[tint * 256 + v]`` (fill 255 past its end, like ``jnp.take``),
    the background select, and the ``rgb_lut[v]`` decode."""
    g = _gather_rows(src, idx, fill)
    if tint_lut is not None:
        lut = tint_lut.reshape(-1)
        j = tint.long()[:, None] * 256 + g.long()
        g = torch.where(j < lut.numel(), lut[j.clamp(max=lut.numel() - 1)], 255)
    out = torch.where(valid[:, None], g, bg[:, None])
    if rgb_lut is not None:
        out = rgb_lut[out.long()]
    return out


# ----------------------------------------------------------- kernel wrappers


def _require(kernel, name, t, dtype, shape, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.device != device):
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def _check_rows(kernel, src, dtypes):
    if (src.dtype not in dtypes or src.dim() != 2 or not src.is_contiguous()
            or src.shape[0] < 1):
        raise ValueError(
            f"{kernel}: src must be a contiguous [rows >= 1, B] tensor of "
            f"{' or '.join(map(str, dtypes))}, got {src.dtype} "
            f"{tuple(src.shape)}")


# K1's and K10's ring paths (``remap_gather.cu``'s and ``ingest.cu``'s
# notes): rows of at least this many bytes, measured on the H100 where each
# ring stops beating its register path (both at 192)
RING_MIN_ROW_BYTES = 192


def ring_path(row_bytes: int, src_ptr: int, out_ptr: int) -> bool:
    """Whether K1 or K10 runs on its ring of bulk copies: rows of at least
    :data:`RING_MIN_ROW_BYTES`, a multiple of 16 bytes, with the source and
    the output on 16-byte boundaries (the bulk copies' alignment).  The one
    place that decides: :func:`remap_gather` and
    :func:`blinky_tpu_torch.kernels.ingest.equirect_gather` launch their
    ring's entry point and count ``remap_gather.bulk_launches`` or
    ``equirect_gather.ring_launches`` on its answer."""
    return (row_bytes >= RING_MIN_ROW_BYTES and row_bytes % 16 == 0
            and src_ptr % 16 == 0 and out_ptr % 16 == 0)


def remap_gather(src, idx, valid, bg, *, fill: bool = False, tint_rgb=None,
                 tint_mask=None):
    """K1: ``out[p] = valid[p] ? src[row(idx[p])] : bg[p]`` -> [N, B].

    ``src`` [R, B] u8 (palette indices) or int32 (packed RGBA bits);
    ``idx`` [N] int32; ``valid`` [N] bool; ``bg`` [N] of src's dtype.
    ``fill`` picks the out-of-range rule (see :func:`_gather_rows`).
    ``tint_rgb`` [N] int32 and ``tint_mask`` [N] bool add the post-gather
    true-color tint (int32 sources only).  Long rows run on the kernel's
    ring of bulk copies (:func:`ring_path`), counted in
    ``remap_gather.bulk_launches`` beside ``remap_gather.launches``.
    """
    k = "remap_gather"
    _check_rows(k, src, (torch.uint8, torch.int32))
    dev, n = src.device, idx.numel()
    _require(k, "idx", idx, torch.int32, (n,), dev)
    _require(k, "valid", valid, torch.bool, (n,), dev)
    _require(k, "bg", bg, src.dtype, (n,), dev)
    if (tint_rgb is None) != (tint_mask is None):
        raise ValueError(f"{k}: tint_rgb and tint_mask come together")
    if tint_rgb is not None:
        if src.dtype != torch.int32:
            raise ValueError(f"{k}: the tint is for packed RGBA (int32) sources")
        _require(k, "tint_rgb", tint_rgb, torch.int32, (n,), dev)
        _require(k, "tint_mask", tint_mask, torch.bool, (n,), dev)
    if not _build.on_card(k, dev):
        return remap_gather_plain(src, idx, valid, bg, fill=fill,
                                  tint_rgb=tint_rgb, tint_mask=tint_mask)
    rows, B = src.shape
    with _build.on_device(dev) as stream:
        out = torch.empty((n, B), dtype=src.dtype, device=dev)
        if out.numel():
            args = (src.data_ptr(), rows, src.element_size(), B, idx.data_ptr(),
                    valid.data_ptr(), bg.data_ptr(), _build.ptr(tint_rgb),
                    _build.ptr(tint_mask), int(fill), n, out.data_ptr(), stream)
            if ring_path(B * src.element_size(), src.data_ptr(), out.data_ptr()):
                _build.launch(remap_gather, k, "blinky_remap_gather_ring", *args)
                remap_gather.bulk_launches += 1
            else:
                _build.launch(remap_gather, k, "blinky_remap_gather", *args)
    return out


remap_gather.launches = 0
remap_gather.bulk_launches = 0


def remap_lut(src, idx, valid, tint, bg, tint_lut=None, rgb_lut=None, *,
              fill: bool = True):
    """K2: the gather through the rubix LUT (``tint_lut`` [7, 256] u8)
    and/or the RGB decode (``rgb_lut`` [256, 3] u8) -> [N, B] u8, or
    [N, B, 3] u8 with the decode.  ``src`` [R, B] u8; ``idx`` [N] int32;
    ``valid`` [N] bool; ``tint`` and ``bg`` [N] u8.  ``fill`` picks the
    out-of-range rule: ``remap_impl``'s fill (the default) or clip, for the
    decode after an expanded gather."""
    k = "remap_lut"
    _check_rows(k, src, (torch.uint8,))
    dev, n = src.device, idx.numel()
    _require(k, "idx", idx, torch.int32, (n,), dev)
    _require(k, "valid", valid, torch.bool, (n,), dev)
    _require(k, "tint", tint, torch.uint8, (n,), dev)
    _require(k, "bg", bg, torch.uint8, (n,), dev)
    if tint_lut is None and rgb_lut is None:
        raise ValueError(f"{k}: needs a tint_lut or an rgb_lut "
                         "(without tables the remap is remap_gather)")
    if tint_lut is not None:
        _require(k, "tint_lut", tint_lut, torch.uint8, (MAX_PLATES + 1, 256), dev)
    if rgb_lut is not None:
        _require(k, "rgb_lut", rgb_lut, torch.uint8, (256, 3), dev)
    if not _build.on_card(k, dev):
        return remap_lut_plain(src, idx, valid, tint, bg, tint_lut, rgb_lut,
                               fill=fill)
    rows, B = src.shape
    shape = (n, B, 3) if rgb_lut is not None else (n, B)
    with _build.on_device(dev) as stream:
        out = torch.empty(shape, dtype=torch.uint8, device=dev)
        if out.numel():
            _build.launch(remap_lut, k, "blinky_remap_lut",
                src.data_ptr(), rows, B, idx.data_ptr(), valid.data_ptr(),
                tint.data_ptr(), bg.data_ptr(), _build.ptr(tint_lut),
                _build.ptr(rgb_lut), int(fill), n, out.data_ptr(), stream)
    return out


remap_lut.launches = 0


# ------------------------------------------------- true-colour resample (K11)

_ALPHA = -(1 << 24)  # 0xFF000000 as int32 bits
# k*k channel values <= 255 sum exactly in float32, in any order, while the
# sum stays under 2^24
MAX_DOWNSAMPLE_FACTOR = 256


def downsample_rgba_plain(hi, factor: int):
    """K11's plain version: ``_downsample_rgba`` on int32 bits.  Per channel
    the k x k sum (integers, exact), converted to float32, divided by a
    float32 *tensor* k*k (a true divide, as ``jnp.mean``'s; PyTorch's CUDA
    division by a Python scalar would multiply by its reciprocal), + 0.5,
    clipped, truncated; alpha 0xFF."""
    k = int(factor)
    H, W = hi.shape[0] // k, hi.shape[1] // k
    rest = tuple(hi.shape[2:])
    count = torch.tensor(float(k * k), dtype=torch.float32, device=hi.device)
    out = None
    for shift in (0, 8, 16):
        c = ((hi >> shift) & 0xFF).reshape((H, k, W, k) + rest).sum(dim=(1, 3))
        c = (c.to(torch.float32) / count + 0.5).clamp(0, 255).to(torch.int32) << shift
        out = c if out is None else out | c
    return out | _ALPHA


def _rgba_tensor(a, device):
    """Packed RGBA (NumPy ``uint32``, or a ``torch.uint32`` / ``torch.int32``
    tensor) -> its int32 bits as a tensor; a NumPy array goes to *device*, a
    tensor stays where it is."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.uint32:
            return a.view(torch.int32)
        if a.dtype != torch.int32:
            raise TypeError("packed RGBA tensors are torch.uint32 (or its int32 "
                            f"bits), got {a.dtype}")
        return a
    return _rgba_bits(np.asarray(a, dtype=np.uint32), device)


def downsample_rgba(hi, factor: int, *, device="cuda"):
    """K11: box-average a packed-RGBA screen by ``factor`` along H and W,
    the resolve step of supersampled rendering (``Session.render_aa``).
    [kH, kW(, B)] u32 -> [H, W(, B)] ``torch.uint32``, per channel in
    float32 with round-half-up.  A tensor (``torch.uint32`` or its int32
    bits) is resolved where it lies; a NumPy array on *device*."""
    name = "downsample_rgba"
    k = int(factor)
    hi = _rgba_tensor(hi, device)
    if hi.dim() not in (2, 3):
        raise ValueError(f"{name}: the screen must be [kH, kW(, B)], got {tuple(hi.shape)}")
    if not 1 <= k <= MAX_DOWNSAMPLE_FACTOR:
        raise ValueError(f"{name}: factor must be 1..{MAX_DOWNSAMPLE_FACTOR}, got {factor}")
    if hi.shape[0] % k or hi.shape[1] % k:
        raise ValueError(f"screen {tuple(hi.shape[:2])} not divisible by {factor}")
    if not _build.on_card(name, hi.device):
        return downsample_rgba_plain(hi, k).view(torch.uint32)
    H, W = hi.shape[0] // k, hi.shape[1] // k
    B = hi.shape[2] if hi.dim() == 3 else 1
    with _build.on_device(hi.device) as stream:
        hi = hi.contiguous()
        out = torch.empty((H, W) + tuple(hi.shape[2:]), dtype=torch.int32, device=hi.device)
        if out.numel():
            _build.launch(downsample_rgba, name, "blinky_downsample_rgba",
                hi.data_ptr(), k, H, W, B, out.data_ptr(), stream)
    return out.view(torch.uint32)


downsample_rgba.launches = 0


# ------------------------------------------------- true-colour expansion (K12)


def _plate_tints_rgb() -> np.ndarray:
    """The six plates' tint colours as packed RGB words, [MAX_PLATES] u32."""
    from blinky_tpu_torch.palette import PLATE_TINTS

    t = PLATE_TINTS.astype(np.uint32)
    return np.ascontiguousarray(t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16))


def tint_expand_rgba_plain(frames):
    """K12's plain version: ``expand_frames_tinted_rgba`` on int32 bits:
    [P, S, S(, B)] -> [2*MAX_PLATES, S, S(, B)], raw plates, zero planes,
    per-plate tinted plates (``c + ((42 * (t - c)) >> 8)`` per channel, an
    arithmetic shift, clipped; alpha 0xFF), zero planes."""
    P = frames.shape[0]
    tints = torch.from_numpy(_plate_tints_rgb().view(np.int32)).to(frames.device)
    always = torch.ones((), dtype=torch.bool, device=frames.device)
    out = frames.new_zeros((2 * MAX_PLATES,) + tuple(frames.shape[1:]))
    out[:P] = frames
    for p in range(P):
        out[MAX_PLATES + p] = _tint_rgba(frames[p], tints[p], always)
    return out


def tint_expand_rgba(frames):
    """K12: the rubix source expansion of packed-RGBA frames held as int32
    bits: ``frames`` [P <= 6, S, S(, B)] int32 -> [12, S, S(, B)] int32 on
    the frames' device."""
    name = "tint_expand_rgba"
    if frames.dtype != torch.int32 or frames.dim() < 1:
        raise ValueError(f"{name}: frames must be int32 (packed RGBA bits) "
                         f"[P, ...], got {frames.dtype} {tuple(frames.shape)}")
    P = frames.shape[0]
    if P > MAX_PLATES:
        raise ValueError(f"{name}: {P} source planes: expected <= {MAX_PLATES}")
    if not _build.on_card(name, frames.device):
        return tint_expand_rgba_plain(frames)
    with _build.on_device(frames.device) as stream:
        frames = frames.contiguous()
        out = torch.empty((2 * MAX_PLATES,) + tuple(frames.shape[1:]), dtype=torch.int32,
                          device=frames.device)
        if out.numel():
            per_plane = out.numel() // (2 * MAX_PLATES)
            tints = _plate_tints_rgb()
            _build.launch(tint_expand_rgba, name, "blinky_tint_expand_rgba",
                frames.data_ptr(), P, per_plane, tints.ctypes.data, out.data_ptr(), stream)
    return out


tint_expand_rgba.launches = 0


# ------------------------------------------------------------ host helpers


def apply_tint_rgba(g, tint_rgb, tint_mask):
    """The true-color rubix tint on gathered packed-RGBA u32 values, on the
    host (``blinky_tpu``'s ``apply_tint_rgba`` with ``xp=np``)."""
    percent = 256 // MAX_PLATES
    a = (g >> 24) & np.uint32(0xFF)
    a = np.where(tint_mask, np.uint32(0xFF), a)
    res = a << 24
    for shift in (0, 8, 16):
        c = ((g >> shift) & 0xFF).astype(np.int32)
        t = ((tint_rgb >> shift) & 0xFF).astype(np.int32)
        c2 = np.clip(c + ((percent * (t - c)) >> 8), 0, 255)
        c = np.where(tint_mask, c2, c)
        res = res | (c.astype(np.uint32) << shift)
    return res


def expanded_flat_idx(lensmap):
    """Gather indices into the expanded (raw||tinted) source, [H, W] i32.

    Pixels whose rubix tint is a plate tint read from the tinted half
    (offset ``MAX_PLATES*S*S``); grid-line / untinted pixels read raw
    (the tint branch of ``render_lensmap``, ``fisheye.c:2416-2419``).
    """
    from blinky_tpu_torch.lensmap.builder import TINT_NONE

    S = lensmap.platesize
    fi = np.asarray(lensmap.flat_idx)
    tint = np.asarray(lensmap.tint)
    valid = np.asarray(lensmap.valid)
    off = np.where((tint != TINT_NONE) & valid, MAX_PLATES * S * S, 0)
    return (fi + off).astype(np.int32)


def compact_planes(lensmap, rubix: bool = False):
    """Renumber the gather indices onto only the source planes actually
    referenced.  Returns ``(plane_ids, flat_idx)``: the planes to keep
    (ascending, into the [MAX_PLATES] or expanded [2*MAX_PLATES] layout)
    and int32 [H, W] indices into the ``[len(plane_ids), S, S]`` source."""
    lm = lensmap
    S = lm.platesize
    idx = np.asarray(expanded_flat_idx(lm) if rubix else lm.flat_idx)
    valid = np.asarray(lm.valid)
    planes = idx // (S * S)
    used = np.unique(planes[valid])
    if used.size == 0:
        used = np.array([0], np.int64)
    renumber = np.zeros(2 * MAX_PLATES, np.int32)
    renumber[used] = np.arange(used.size, dtype=np.int32)
    new_idx = np.where(valid, renumber[planes] * (S * S) + idx % (S * S), 0)
    return tuple(int(p) for p in used), new_idx.astype(np.int32)


def compact_rows(lensmap, rubix: bool = False):
    """Row-cropped source compaction: per used plane, only the contiguous
    row band the gather touches.  Returns ``(slabs, flat_idx)``: ``slabs``
    is ``(plane_id, row_lo, row_hi)`` per used plane, ascending, describing
    the row-stacked source ``[sum(hi-lo), S(, B)]`` (:func:`crop_frames_rows`),
    and ``flat_idx`` int32 [H, W] indices into its flat rows."""
    lm = lensmap
    S = lm.platesize
    idx = np.asarray(expanded_flat_idx(lm) if rubix else lm.flat_idx)
    valid = np.asarray(lm.valid)
    planes = idx // (S * S)
    rows = (idx // S) % S
    slabs = []
    base = np.zeros(2 * MAX_PLATES, np.int64)  # per-plane: stack_base - lo
    total = 0
    for p in np.unique(planes[valid]):
        r = rows[valid & (planes == p)]
        lo, hi = int(r.min()), int(r.max()) + 1
        slabs.append((int(p), lo, hi))
        base[p] = total - lo
        total += hi - lo
    if not slabs:
        slabs.append((0, 0, 1))
    new_idx = np.where(valid, (base[planes] + rows) * S + idx % S, 0)
    return tuple(slabs), new_idx.astype(np.int32)


def crop_frames_rows(frames, slabs) -> np.ndarray:
    """Materialize the row-cropped source stack for :func:`compact_rows`:
    [P, S, S(, B)] -> [sum(hi-lo), S(, B)]."""
    frames = np.asarray(frames)
    return np.concatenate([frames[p, lo:hi] for p, lo, hi in slabs], axis=0)


def compact_texels(lensmap, rubix: bool = False):
    """Texel-level source compaction: keep exactly the unique texels the
    lensmap's gather references.  Returns ``(texels, flat_idx)``:
    ``texels`` int64 [R] flat texel ids into the ``[P*S*S]`` (or expanded
    ``[2*P*S*S]``) space, ascending, and ``flat_idx`` int32 [H, W] gather
    indices into the compacted ``[R(, B)]`` source (:func:`take_texels`)."""
    lm = lensmap
    idx = np.asarray(expanded_flat_idx(lm) if rubix else lm.flat_idx)
    valid = np.asarray(lm.valid)
    uniq, inv = np.unique(idx[valid], return_inverse=True)
    if uniq.size == 0:
        uniq = np.zeros(1, np.int64)
    new_idx = np.zeros(idx.shape, np.int32)
    new_idx[valid] = inv.astype(np.int32)
    return uniq.astype(np.int64), new_idx


def take_texels(frames, texels) -> np.ndarray:
    """Materialize the texel-compacted source for :func:`compact_texels`:
    [P, S, S] -> [R] or [P, S, S, B] -> [R, B]."""
    frames = np.asarray(frames)
    if frames.ndim == 3:
        return frames.reshape(-1)[texels]
    return frames.reshape(-1, frames.shape[-1])[texels]


def expand_frames_tinted(frames, palette, palmap=None) -> np.ndarray:
    """Host-side source expansion for the fast rubix path:
    [P, S, S(, B)] u8 -> [2*MAX_PLATES, S, S(, B)]: raw plates (padded to
    MAX_PLATES) followed by each plate run through its own tint palette
    (``palmap[p]``, ``fisheye.c:2416-2419``)."""
    frames = np.asarray(frames, dtype=np.uint8)
    if palmap is None:
        palmap = create_palmap(np.asarray(palette))
    out = np.zeros((2 * MAX_PLATES,) + frames.shape[1:], dtype=np.uint8)
    out[: frames.shape[0]] = frames
    for p in range(frames.shape[0]):
        out[MAX_PLATES + p] = palmap[p][frames[p]]
    return out


def expand_rubix_source(frames, palette, palmap=None):
    """Dtype-dispatching rubix expansion: route a [P, S, S(, B)] source
    to :func:`expand_frames_tinted` (u8 via the per-plate tint palettes)
    or :func:`expand_frames_tinted_rgba` (packed-RGBA u32, NumPy or a
    tensor): the one entry every batched/posed rubix producer shares.  The
    u8 expansion is host-only and returns NumPy: a u8 tensor on the CPU is
    taken as its array, one on the card raises (nothing leaves the card
    unasked; hand over ``frames.cpu()``)."""
    if isinstance(frames, torch.Tensor):
        if frames.dtype in (torch.uint32, torch.int32):
            return expand_frames_tinted_rgba(frames)
        if frames.device.type != "cpu":
            raise TypeError(
                "expand_frames_tinted (the u8 rubix expansion) is host-only: "
                f"got a {frames.dtype} tensor on {frames.device}; pass "
                "frames.cpu(), or packed-RGBA frames, which expand on the card")
        frames = frames.numpy()
    frames = np.asarray(frames)
    if frames.dtype == np.uint32:
        return expand_frames_tinted_rgba(frames)
    return expand_frames_tinted(frames, palette, palmap=palmap)


def frames_to_rgba(frames, palette) -> np.ndarray:
    """Host-side palette decode to packed RGBA uint32 (little-endian
    r|g<<8|b<<16|ff<<24), same shape as *frames*."""
    lut = rgba_lut(np.asarray(palette))
    return lut[np.asarray(frames, dtype=np.uint8)]


def pack_rgba(rgb) -> np.ndarray:
    """[..., 3] (or [..., 4]) u8 -> packed RGBA uint32 (little-endian)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    if rgb.shape[-1] == 3:
        a = np.full(rgb.shape[:-1] + (1,), 255, np.uint8)
        rgb = np.concatenate([rgb, a], axis=-1)
    elif rgb.shape[-1] != 4:
        raise ValueError("pack_rgba expects a trailing RGB(A) axis")
    return (
        rgb[..., 0].astype(np.uint32)
        | (rgb[..., 1].astype(np.uint32) << 8)
        | (rgb[..., 2].astype(np.uint32) << 16)
        | (rgb[..., 3].astype(np.uint32) << 24)
    )


def unpack_rgb(rgba) -> np.ndarray:
    """Packed RGBA uint32 -> [..., 3] u8 (drops alpha)."""
    rgba = np.asarray(rgba, dtype=np.uint32)
    return np.stack(
        [(rgba >> s).astype(np.uint8) for s in (0, 8, 16)], axis=-1)


def expand_frames_tinted_rgba(frames_rgba):
    """Rubix source expansion for true-color (packed RGBA u32) frames:
    [P, S, S(, B)] u32 -> [2*MAX_PLATES, S, S(, B)] u32, raw plates
    then per-plate tinted plates (``c += percent*(tint-c) >> 8`` per
    channel, ``fisheye.c:884-901``, without the palette snap).

    A NumPy array expands on the host and returns NumPy.  A tensor
    (``torch.uint32``, or its int32 bits) expands where it lies, through K12
    (:func:`tint_expand_rgba`) on a card, and returns its own dtype:
    ``Session.render_aa`` and the equirect path use this to keep a rubix
    source on the device."""
    from blinky_tpu_torch.palette import PLATE_TINTS

    if isinstance(frames_rgba, torch.Tensor):
        out = tint_expand_rgba(_rgba_tensor(frames_rgba, None))
        return out.view(torch.uint32) if frames_rgba.dtype == torch.uint32 else out

    frames_rgba = np.asarray(frames_rgba, dtype=np.uint32)
    percent = 256 // MAX_PLATES
    nplates = frames_rgba.shape[0]
    pad = np.zeros((MAX_PLATES - nplates,) + frames_rgba.shape[1:], np.uint32)
    tinted_plates = []
    for p in range(nplates):
        tinted = np.uint32(0xFF) << np.uint32(24)  # alpha
        for ch, shift in enumerate((0, 8, 16)):
            c = ((frames_rgba[p] >> shift) & 0xFF).astype(np.int32)
            t = int(PLATE_TINTS[p, ch])
            c = np.clip(c + ((percent * (t - c)) >> 8), 0, 255)
            tinted = tinted | (c.astype(np.uint32) << shift)
        tinted_plates.append(tinted)
    return np.concatenate(
        [frames_rgba, pad, np.stack(tinted_plates), pad], axis=0)


def _tint_rgb_mask_np(lensmap):
    """(tint_rgb [H, W] u32, tint_mask [H, W] bool) of the post-gather
    true-color tint: each pixel's plate tint colour, masked where the pixel
    is untinted or invalid."""
    from blinky_tpu_torch.lensmap.builder import TINT_NONE
    from blinky_tpu_torch.palette import PLATE_TINTS

    lut = pack_rgba(np.concatenate(
        [PLATE_TINTS.astype(np.uint8), np.zeros((1, 3), np.uint8)]))
    tint = np.asarray(lensmap.tint).astype(np.int32)
    return lut[tint], (tint != TINT_NONE) & np.asarray(lensmap.valid)


# ------------------------------------------------------------------ kernel


def frames_tensor(frames):
    """Frames (NumPy or tensor) -> (tensor, is_rgba): packed RGBA as int32
    bits, any dtype but u8/u32 normalized to u8 palette indices.  A NumPy
    array becomes a contiguous CPU tensor; a tensor stays where it is."""
    if isinstance(frames, torch.Tensor):
        if frames.dtype == torch.uint32:
            return frames.view(torch.int32), True
        return (frames if frames.dtype == torch.uint8 else frames.to(torch.uint8)), False
    a = np.asarray(frames)
    is_rgba = a.dtype == np.uint32
    a = a.view(np.int32) if is_rgba else a.astype(np.uint8, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)), is_rgba


def host_array(x) -> np.ndarray:
    """A result as a NumPy array on the host: a tensor copied from its
    device (``torch.uint32`` through its int32 bits, to NumPy ``uint32``);
    anything else (a NumPy array, a
    :class:`blinky_tpu_torch.parallel.ShardedArray`) through
    ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        if x.dtype == torch.uint32:
            return x.view(torch.int32).numpy().view(np.uint32)
        return x.numpy()
    return np.asarray(x)


def _rgba_bits(a: np.ndarray, device) -> torch.Tensor:
    """Packed RGBA uint32 NumPy array -> its int32 bits on *device*."""
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)).to(device)


class RemapKernel:
    """Holds a lensmap's operands and LUTs on a device for repeated frames.

    Usage::

        k = RemapKernel(lensmap, palette, device="cuda")
        out = k(frames)                        # [6, S, S, B] u8 -> [H, W, B] u8

    Source kinds (as :class:`blinky_tpu.kernels.remap.RemapKernel`):

    * ``[P<=6, S, S(, B)]`` u8 palette indices -> K1 (fill rule); with
      ``rubix`` and/or ``decode_rgb`` -> K2, the general LUT path;
    * ``[12, S, S(, B)]`` u8 from :func:`expand_frames_tinted`: rubix rides
      the static indices -> K1 (clip rule), or K2 with ``decode_rgb``;
    * either layout as packed RGBA uint32 (:func:`frames_to_rgba`) -> K1
      (clip rule); ``rubix`` on a non-expanded u32 source adds the
      post-gather tint.  Returns ``torch.uint32``.

    Frames may be NumPy arrays or tensors; they are moved to the kernel's
    device (``"cuda"`` unless the caller asks for another).  Outputs are
    tensors on that device.
    """

    @spanned("build.remap_kernel")
    def __init__(self, lensmap, palette=None, background=None, *, device="cuda"):
        self.device = torch.device(device)
        self.lensmap = lensmap
        self.height_px = lensmap.height_px
        self.width_px = lensmap.width_px
        self.platesize = lensmap.platesize
        t = lensmap.to_torch(self.device)  # a table built there stays there
        self.flat_idx = t["flat_idx"].reshape(-1)
        self.valid = t["valid"].reshape(-1)
        self.tint = t["tint"].reshape(-1)
        self._flat_idx_rubix = None
        self._tint_rgb_mask = None
        self.palette = None if palette is None else np.asarray(palette)
        self._tint_lut = None
        self.rgb_lut = None if palette is None else torch.from_numpy(
            np.ascontiguousarray(self.palette, dtype=np.uint8)).to(self.device)
        if background is None:
            background = np.zeros((self.height_px, self.width_px), np.uint8)
        background = np.asarray(background)
        if background.size != self.height_px * self.width_px:
            raise ValueError(
                f"background of {background.shape} does not match the "
                f"{self.height_px}x{self.width_px} screen")
        if background.dtype == np.uint32:
            # packed-RGBA background (true-color pipelines): u8 sources
            # raise on it (__call__)
            self.background_np = background
            self.background = None
            self._background_rgba = _rgba_bits(background.reshape(-1), self.device)
        else:
            self.background_np = background.astype(np.uint8, copy=False)
            self.background = torch.from_numpy(
                np.ascontiguousarray(self.background_np).reshape(-1)).to(self.device)
            self._background_rgba = None

    @property
    def tint_lut(self):
        """The [7, 256] rubix tint LUT on the device, or None without a
        palette; made at first use (its nearest-colour search takes about a
        millisecond on the host, which a plain render after each lensmap
        rebuild need not pay)."""
        from blinky_tpu_torch import palette as pal

        if self._tint_lut is None and self.palette is not None:
            self._tint_lut = torch.from_numpy(pal.tint_lut(self.palette)).to(self.device)
        return self._tint_lut

    @property
    def flat_idx_rubix(self):
        """:func:`expanded_flat_idx` of the lensmap, from the operands on
        the device (a table built there never visits the host)."""
        from blinky_tpu_torch.lensmap.builder import TINT_NONE

        if self._flat_idx_rubix is None:
            S = self.platesize
            off = torch.where((self.tint != TINT_NONE) & self.valid, MAX_PLATES * S * S, 0)
            self._flat_idx_rubix = (self.flat_idx + off).to(torch.int32)
        return self._flat_idx_rubix

    @property
    def tint_rgb_mask(self):
        """(tint_rgb [H*W] int32 bits, tint_mask [H*W] bool) for the
        post-gather true-color tint (:func:`_tint_rgb_mask_np` from the
        operands on the device)."""
        from blinky_tpu_torch.lensmap.builder import TINT_NONE
        from blinky_tpu_torch.palette import PLATE_TINTS

        if self._tint_rgb_mask is None:
            lut = _rgba_bits(pack_rgba(np.concatenate(
                [PLATE_TINTS.astype(np.uint8), np.zeros((1, 3), np.uint8)])), self.device)
            self._tint_rgb_mask = (lut[self.tint.long()],
                                   (self.tint != TINT_NONE) & self.valid)
        return self._tint_rgb_mask

    @property
    def background_rgba(self):
        if self._background_rgba is None:
            if self.palette is None:
                raise ValueError("RGBA remap needs a palette")
            self._background_rgba = _rgba_bits(
                frames_to_rgba(self.background_np, self.palette).reshape(-1),
                self.device)
        return self._background_rgba

    def __call__(self, frames, rubix: bool = False, decode_rgb: bool = False):
        frames, is_rgba = frames_tensor(frames)
        frames = frames.to(self.device).contiguous()
        squeeze = frames.dim() == 3  # single frame [P, S, S]
        if squeeze:
            frames = frames[..., None]
        expanded = frames.shape[0] == 2 * MAX_PLATES
        if not expanded and frames.shape[0] != MAX_PLATES:
            pad = MAX_PLATES - frames.shape[0]
            if pad < 0:
                raise ValueError(f"{frames.shape[0]} source planes: expected "
                                 f"<= {MAX_PLATES} or {2 * MAX_PLATES}")
            frames = torch.cat(
                [frames, frames.new_zeros((pad,) + tuple(frames.shape[1:]))])
        if not is_rgba and self.background is None:
            raise ValueError("u8 frames need a u8 (palette-index) "
                             "background, got uint32")
        B = frames.shape[-1]
        src = frames.reshape(-1, B)
        if expanded or is_rgba:
            idx = self.flat_idx_rubix if (rubix and expanded) else self.flat_idx
            bg = self.background_rgba if is_rgba else self.background
            if decode_rgb and not is_rgba:
                if self.rgb_lut is None:
                    raise ValueError("RemapKernel needs a palette for RGB decode")
                out = remap_lut(src, idx, self.valid, self.tint, bg,
                                rgb_lut=self.rgb_lut, fill=False)
            elif rubix and not expanded:
                # u32 only: the true-color tint after the gather
                tr, tm = self.tint_rgb_mask
                out = remap_gather(src, idx, self.valid, bg, tint_rgb=tr,
                                   tint_mask=tm)
            else:
                out = remap_gather(src, idx, self.valid, bg)
        elif rubix or decode_rgb:
            if self.tint_lut is None:
                raise ValueError("RemapKernel needs a palette for rubix/RGB decode")
            out = remap_lut(src, self.flat_idx, self.valid, self.tint,
                            self.background, self.tint_lut if rubix else None,
                            self.rgb_lut if decode_rgb else None, fill=True)
        else:
            out = remap_gather(src, self.flat_idx, self.valid, self.background,
                               fill=True)
        out = out.reshape((self.height_px, self.width_px) + tuple(out.shape[1:]))
        if squeeze:
            out = out[..., 0, :] if (decode_rgb and not is_rgba) else out[..., 0]
        return out.view(torch.uint32) if is_rgba else out


def remap_frames(lensmap, frames, palette=None, background=None, rubix=False,
                 decode_rgb=False, *, device="cuda"):
    """One-shot convenience wrapper around :class:`RemapKernel` on *device*."""
    return RemapKernel(lensmap, palette, background, device=device)(
        frames, rubix=rubix, decode_rgb=decode_rgb)


def host_remap(lensmap, frame, palette=None, background=None,
               rubix=False, decode_rgb=False) -> np.ndarray:
    """Pure-NumPy single-frame remap: no device.

    Bit-equal to :class:`RemapKernel` on the same lensmap for every source
    kind (u8, expanded raw||tinted, packed-RGBA u32): the same tint LUT,
    the same expanded-index arithmetic, the same post-gather u32 tint,
    and the clip rule of the device gather.

    ``frame``: one [P, S, S] u8/u32 frame.  Returns [H, W] (u8 or u32),
    or [H, W, 3] u8 with ``decode_rgb`` on a u8 source.
    """
    from blinky_tpu_torch import palette as pal_mod

    lm = lensmap
    frame = np.asarray(frame)
    if frame.ndim != 3:
        raise ValueError("host_remap takes one [P, S, S] frame")
    is_rgba = frame.dtype == np.uint32
    if not is_rgba:
        frame = frame.astype(np.uint8, copy=False)
    expanded = frame.shape[0] == 2 * MAX_PLATES
    # no platesize validation on purpose: size mismatches clip
    idx = expanded_flat_idx(lm) if (rubix and expanded) else lm.flat_idx
    src = frame.reshape(-1)
    g = src[np.clip(idx, 0, src.size - 1)]  # [H, W], mode="clip"
    if rubix and not expanded:
        if is_rgba:
            tr, tm = _tint_rgb_mask_np(lm)
            g = apply_tint_rgba(g, tr, tm)
        else:
            if palette is None:
                raise ValueError("host_remap needs a palette for u8 rubix")
            lut = pal_mod.tint_lut(np.asarray(palette))
            g = lut[lm.tint.astype(np.int32), g.astype(np.int32)]
    if background is None:
        background = np.zeros((lm.height_px, lm.width_px), np.uint8)
    bg = np.asarray(background).reshape(lm.height_px, lm.width_px)
    if is_rgba:
        if bg.dtype != np.uint32:
            if palette is None:
                raise ValueError("host_remap needs a palette for the RGBA "
                                 "background")
            bg = frames_to_rgba(bg, np.asarray(palette))
    elif bg.dtype == np.uint32:
        raise ValueError("u8 frames need a u8 (palette-index) background, "
                         "got uint32")
    out = np.where(lm.valid, g, bg)
    if decode_rgb and not is_rgba:
        if palette is None:
            raise ValueError("host_remap needs a palette for RGB decode")
        out = np.asarray(palette, np.uint8)[out.astype(np.int32)]
    return out
