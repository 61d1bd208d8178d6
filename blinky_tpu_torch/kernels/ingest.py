"""Equirect -> cubemap ingestion on the device: a static gather, like the remap.

The port of :mod:`blinky_tpu.kernels.ingest`.  The pano -> plate resampling
geometry depends only on (pano size, platesize, globe), never on the frame,
so it compiles to a static index/weight table exactly like the lensmap.
Ingesting a video batch is then one device call: K row gathers (K=1 nearest,
K=4 bilinear) over batch-innermost panos plus a per-channel float32 blend,
with no per-frame trigonometry.

Geometry matches :func:`blinky_tpu_torch.io.cubemap.equirect_to_cubemap`
(which delegates its per-frame host path to these tables): plate texel ->
``plate_uv_to_ray`` (``fisheye.c:1198-1214``) -> ``ray_to_latlon``
(``fisheye.c:1192``) -> equirect row/col with longitude wrap and pole clamp.
The tables are made in NumPy float64 on the host, bit-equal to the JAX
package's; the weights are float32 in the host and the device executor, so
the two agree bit for bit.

One hand-written CUDA kernel does the device work (``csrc/ingest.cu``):
K10, :func:`equirect_gather`, the K-tap gather and blend with its epilogue
fused (the plate mask of the ingest, or the tint and background select of
the composed pano -> screen kernel).  Beside it stands its plain PyTorch
version, :func:`equirect_gather_plain`, which the wrapper runs for tensors
on the CPU and nothing runs on a card outside checks.  **The blend's rounding
rule**: per colour channel ``acc = ((c0*w0 + c1*w1) + c2*w2) + c3*w3`` with
every product and every sum rounded to float32 on its own, then
``acc + 0.5``, clipped to [0, 255], truncated; alpha is 0xFF.  With one tap
the row passes through whole, its alpha byte too.

Packed RGBA travels as ``torch.int32`` bits inside (``torch.uint32`` is
storage-only); the classes take NumPy ``uint32`` or ``torch.uint32`` /
``torch.int32`` panos and return ``torch.uint32``.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch import geometry
from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.kernels.remap import (
    _ALPHA, _check_rows, _require, _rgba_tensor, _tint_rgba, compact_texels, remap_gather,
    ring_path,
)
from blinky_tpu_torch.palette import MAX_PLATES
from blinky_tpu_torch.utils.timing import spanned


def _build_tables(pano_h, pano_w, platesize, globe, bilinear):
    """Static (indices [K, P*S*S] i32 into the flattened pano,
    weights [K, P*S*S] f32) for every plate texel; unused plates point
    at index 0 with weight 0."""
    S = int(platesize)
    H, W = int(pano_h), int(pano_w)
    grid = (np.arange(S, dtype=np.float64) + 0.5) / S
    u, v = np.meshgrid(grid, grid)  # [S, S], v = rows

    K = 4 if bilinear else 1
    idx = np.zeros((K, MAX_PLATES, S, S), np.int64)
    w = np.zeros((K, MAX_PLATES, S, S), np.float32)
    for p in range(globe.numplates):
        x, y, z = geometry.plate_uv_to_ray(
            u, v,
            np.asarray(globe.forward[p], np.float64),
            np.asarray(globe.right[p], np.float64),
            np.asarray(globe.up[p], np.float64),
            float(globe.dist[p]),
        )
        lat, lon = geometry.ray_to_latlon(x, y, z)
        col = (lon + np.pi) / (2 * np.pi) * W  # wraps
        row = (np.pi / 2 - lat) / np.pi * H    # clamps at the poles
        if bilinear:
            c0 = np.floor(col - 0.5).astype(np.int64)
            r0 = np.floor(row - 0.5).astype(np.int64)
            fc = (col - 0.5 - c0).astype(np.float32)
            fr = (row - 0.5 - r0).astype(np.float32)
            for k, (dc, dr) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                ri = np.clip(r0 + dr, 0, H - 1)
                ci = np.mod(c0 + dc, W)
                idx[k, p] = ri * W + ci
                w[k, p] = ((fc if dc else 1 - fc) *
                           (fr if dr else 1 - fr)).astype(np.float32)
        else:
            ri = np.clip(np.floor(row).astype(np.int64), 0, H - 1)
            ci = np.mod(np.floor(col).astype(np.int64), W)
            idx[0, p] = ri * W + ci
            w[0, p] = 1.0
    return idx.reshape(K, -1).astype(np.int32), w.reshape(K, -1)


# ------------------------------------------------------------------ K10


def equirect_gather_plain(src, idx, w=None, *, plate_mask=None, valid=None,
                          bg=None, tint_rgb=None, tint_mask=None):
    """K10's plain version: the jitted ``run`` of ``EquirectIngest.__call__``
    (with *plate_mask*) and of ``EquirectScreenKernel.__call__`` (with
    *valid* and *bg*, and the tint operands when rubix), as tensor
    operations in the reference's order: gather, blend, tint, mask, select.
    Products and sums are separate operations, so each rounds on its own."""
    rows = src.shape[0]
    taps = [src.index_select(0, idx[k].long().clamp(0, rows - 1))
            for k in range(idx.shape[0])]
    if len(taps) == 1:
        g = taps[0]
    else:
        g = None
        for shift in (0, 8, 16):
            acc = None
            for k, r in enumerate(taps):
                term = ((r >> shift) & 0xFF).to(torch.float32) * w[k][:, None]
                acc = term if acc is None else acc + term
            ch = (acc + 0.5).clamp(0, 255).to(torch.int32) << shift
            g = ch if g is None else g | ch
        g = g | _ALPHA
    if tint_rgb is not None:
        g = _tint_rgba(g, tint_rgb[:, None], tint_mask[:, None])
    if plate_mask is not None:
        g = g & plate_mask[:, None]
    if valid is not None:
        g = torch.where(valid[:, None], g, bg[:, None])
    return g


def equirect_gather(src, idx, w=None, *, plate_mask=None, valid=None, bg=None,
                    tint_rgb=None, tint_mask=None):
    """K10: the K-tap row gather and blend with a fused epilogue -> [n, B]
    int32 bits.

    ``src`` [rows, B] int32 (packed RGBA bits); ``idx`` [K, n] int32 rows of
    *src*, K 1 or 4 (an index outside [0, rows) is clipped; the tables of
    this module never hold one); ``w`` [K, n] float32, needed when K = 4.
    The epilogue follows the operands given: ``plate_mask`` [n] int32, ANDed
    onto the blend (the ingest); or ``valid`` [n] bool with ``bg`` [n] int32,
    which shows where a pixel is not valid, and optionally ``tint_rgb`` [n]
    int32 with ``tint_mask`` [n] bool, the true-colour tint applied between
    the blend and the select (the composed screen kernel).  Long rows run on
    the kernel's ring of bulk copies, decided by K1's rule
    (:func:`blinky_tpu_torch.kernels.remap.ring_path`: the ring wins from
    the same row size on), counted in ``equirect_gather.ring_launches``
    beside ``equirect_gather.launches``.
    """
    k = "equirect_gather"
    _check_rows(k, src, (torch.int32,))
    dev = src.device
    if idx.dim() != 2 or idx.shape[0] not in (1, 4):
        raise ValueError(f"{k}: idx must be [K, n] with K 1 or 4, got {tuple(idx.shape)}")
    taps, n = idx.shape
    _require(k, "idx", idx, torch.int32, (taps, n), dev)
    if taps == 4 or w is not None:
        if w is None:
            raise ValueError(f"{k}: four taps need their weights w [4, n]")
        _require(k, "w", w, torch.float32, (taps, n), dev)
    if (valid is None) != (bg is None):
        raise ValueError(f"{k}: valid and bg come together")
    if (tint_rgb is None) != (tint_mask is None):
        raise ValueError(f"{k}: tint_rgb and tint_mask come together")
    for name, t, dtype in (("plate_mask", plate_mask, torch.int32),
                           ("valid", valid, torch.bool), ("bg", bg, torch.int32),
                           ("tint_rgb", tint_rgb, torch.int32),
                           ("tint_mask", tint_mask, torch.bool)):
        if t is not None:
            _require(k, name, t, dtype, (n,), dev)
    if not _build.on_card(k, dev):
        return equirect_gather_plain(src, idx, w, plate_mask=plate_mask, valid=valid,
                                     bg=bg, tint_rgb=tint_rgb, tint_mask=tint_mask)
    rows, B = src.shape
    with _build.on_device(dev) as stream:
        out = torch.empty((n, B), dtype=torch.int32, device=dev)
        if out.numel():
            args = (src.data_ptr(), rows, B, idx.data_ptr(), _build.ptr(w), taps, n,
                    _build.ptr(plate_mask), _build.ptr(valid), _build.ptr(bg),
                    _build.ptr(tint_rgb), _build.ptr(tint_mask), out.data_ptr(), stream)
            if ring_path(B * 4, src.data_ptr(), out.data_ptr()):
                _build.launch(equirect_gather, k, "blinky_equirect_gather_ring", *args)
                equirect_gather.ring_launches += 1
            else:
                _build.launch(equirect_gather, k, "blinky_equirect_gather", *args)
    return out


equirect_gather.launches = 0
equirect_gather.ring_launches = 0


def panos_bits(panos, pano_hw, device):
    """Panos (NumPy ``uint32`` or a ``torch.uint32`` / ``torch.int32``
    tensor, ``[H, W, B]``) -> their int32 bits as contiguous ``[H*W, B]``
    rows on *device*.  A tensor already there is not copied through the
    host."""
    shape = tuple(getattr(panos, "shape", ()))
    if len(shape) != 3 or shape[:2] != tuple(pano_hw):
        raise ValueError(f"panos must be [H, W, B] = "
                         f"{tuple(pano_hw) + ('B',)}, got {shape}")
    return _rgba_tensor(panos, device).to(device).reshape(-1, shape[2]).contiguous()


# ---------------------------------------------------------------- classes


class EquirectIngest:
    """Reusable pano -> plates resampler for one (pano size, platesize,
    globe, sampling) configuration.

    * ``__call__(panos)``: device path: ``[H, W, B]`` packed-RGBA u32
      (batch-innermost, like every source here; NumPy or a tensor) ->
      ``[MAX_PLATES, S, S, B]`` ``torch.uint32`` on *device* (``"cuda"``
      unless the caller asks for another), one launch of K10.  The tables
      are uploaded at the first call and stay there.
    * ``host(pano)``: NumPy path for a single ``[H, W]`` u32 pano, identical
      tables and float32 weights (bit-equal to the device path's math).
    """

    @spanned("build.ingest")
    def __init__(self, pano_h: int, pano_w: int, platesize: int,
                 globe=None, bilinear: bool = True, *, device="cuda"):
        from blinky_tpu_torch import globes as globes_mod

        self.device = torch.device(device)
        self.globe = globes_mod.get("cube") if globe is None else globe
        self.platesize = int(platesize)
        self.pano_hw = (int(pano_h), int(pano_w))
        self.bilinear = bool(bilinear)
        self.idx, self.w = _build_tables(pano_h, pano_w, platesize,
                                         self.globe, bilinear)
        # plates beyond the globe's count are zeroed in the output (their
        # table rows point at index 0, which would otherwise replicate
        # the pano's top-left texel through the nearest path)
        mask = np.zeros(MAX_PLATES, np.uint32)
        mask[: self.globe.numplates] = 0xFFFFFFFF
        self.plate_mask = np.repeat(mask, self.platesize * self.platesize)
        self._device_tables = None

    # shared math: K gathered u32 rows -> blended u32 (float32 weights)
    @staticmethod
    def _blend(rows, w):
        if len(rows) == 1:
            return rows[0]
        out = np.zeros_like(rows[0]) | (np.uint32(0xFF) << 24)
        for shift in (0, 8, 16):
            acc = None
            for k, r in enumerate(rows):
                c = ((r >> shift) & 0xFF).astype(np.float32)
                wk = w[k].reshape(w[k].shape + (1,) * (r.ndim - 1))
                acc = c * wk if acc is None else acc + c * wk
            ch = np.clip(acc + 0.5, 0, 255).astype(np.uint32)
            out = out | (ch << shift)
        return out

    # _texel_shape is how the flat texel axis reshapes in outputs:
    # (MAX_PLATES, S, S) here, (R,) for a texel subset; everything else
    # (tables, validation, gather, blend, mask) is shared
    @property
    def _texel_shape(self):
        return (MAX_PLATES, self.platesize, self.platesize)

    def device_tables(self):
        """(idx [K, n] int32, w [K, n] float32, plate_mask [n] int32 bits)
        on the ingest's device, uploaded once."""
        if self._device_tables is None:
            self._device_tables = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (self.idx, self.w, self.plate_mask.view(np.int32)))
        return self._device_tables

    def gather_bits(self, panos):
        """``__call__`` without the reshape: [H, W, B] panos -> [n, B] int32
        bits on the device, n the flat texel count."""
        src = panos_bits(panos, self.pano_hw, self.device)
        idx, w, pmask = self.device_tables()
        return equirect_gather(src, idx, w if self.bilinear else None,
                               plate_mask=pmask)

    def __call__(self, panos):
        """[H, W, B] u32 (batch-innermost) -> [MAX_PLATES, S, S, B]
        ``torch.uint32`` (``[R, B]`` for a :meth:`subset` view).

        Single panos go through :meth:`host`, or pass ``[..., None]``."""
        out = self.gather_bits(panos)
        return out.reshape(self._texel_shape + (out.shape[1],)).view(torch.uint32)

    def host(self, pano) -> np.ndarray:
        """NumPy executor over one [H, W] u32 pano -> [P, S, S] u32
        (``[R]`` for a :meth:`subset` view)."""
        pano = np.asarray(pano, np.uint32)
        if pano.shape != self.pano_hw:
            raise ValueError(f"pano shape {pano.shape} != {self.pano_hw}")
        flat = pano.reshape(-1)
        rows = [flat[self.idx[k]] for k in range(self.idx.shape[0])]
        out = self._blend(rows, self.w) & self.plate_mask
        return out.reshape(self._texel_shape)

    def subset(self, texels):
        """A view of this ingest that resamples ONLY the given flat plate
        texels; compose with ``kernels.remap.compact_texels`` so a chained
        pano -> remap pipeline never computes a texel the remap won't read.

        ``texels``: [R] int flat ids into the ``[MAX_PLATES*S*S]`` texel
        space (``compact_texels``' first return).  The subset's
        ``__call__`` maps ``[H, W, B]`` panos -> ``[R, B]`` u32 (feed
        :func:`blinky_tpu_torch.kernels.remap.remap_gather` with the
        compacted indices), ``host`` maps one pano -> ``[R]``.  Geometry
        stays in :func:`_build_tables`: this only slices the static
        tables, so subset outputs are bit-equal to the matching texels
        of the full ingest."""
        return _EquirectIngestSubset(self, np.asarray(texels, np.int64))

    def host_nearest_u8(self, pano) -> np.ndarray:
        """Nearest-neighbor executor for u8 palette panos (indices don't
        blend); requires ``bilinear=False`` tables."""
        if self.bilinear:
            raise ValueError("palette panos need bilinear=False tables")
        pano = np.asarray(pano, np.uint8)
        if pano.shape != self.pano_hw:
            raise ValueError(f"pano shape {pano.shape} != {self.pano_hw}")
        out = pano.reshape(-1)[self.idx[0]] & self.plate_mask.astype(np.uint8)
        return out.reshape(MAX_PLATES, self.platesize, self.platesize)


class _EquirectIngestSubset(EquirectIngest):
    """Texel-subset view of an :class:`EquirectIngest` (see
    :meth:`EquirectIngest.subset`): the parent's static tables sliced to
    the kept texels; ``__call__``/``host`` are inherited (only the
    output ``_texel_shape`` differs: flat ``[R]``)."""

    def __init__(self, parent: EquirectIngest, texels):
        # deliberately no super().__init__: tables come sliced from the
        # parent (and the parent object is NOT retained: a subset must
        # not pin the full-size tables alive)
        self.device = parent.device
        self.globe = parent.globe
        self.platesize = parent.platesize
        self.bilinear = parent.bilinear
        self.texels = texels
        self.pano_hw = parent.pano_hw
        self.idx = parent.idx[:, texels]
        self.w = parent.w[:, texels]
        self.plate_mask = parent.plate_mask[texels]
        self._device_tables = None

    @property
    def _texel_shape(self):
        return (self.texels.size,)

    def subset(self, texels):
        raise TypeError("already a texel subset: slice the original "
                        "EquirectIngest instead")

    def host_nearest_u8(self, pano) -> np.ndarray:
        raise TypeError("host_nearest_u8 needs the full-plate layout: "
                        "use the original EquirectIngest")


def _check_composition(ingest, remap, why_full):
    if isinstance(ingest, _EquirectIngestSubset):
        raise TypeError(why_full)
    lm = remap.lensmap
    if ingest.platesize != lm.platesize:
        raise ValueError(
            f"ingest platesize {ingest.platesize} != lensmap "
            f"platesize {lm.platesize}")
    if ingest.device != remap.device:
        raise ValueError(f"the ingest's tables are on {ingest.device}, the "
                         f"remap's on {remap.device}: build both on one device")


class EquirectScreenKernel:
    """Fused pano -> screen: the ingest's K-tap tables composed THROUGH the
    lensmap so the whole 360-video chain is ONE gather stage (the
    reference's own one-hop ``render_lensmap`` design,
    ``fisheye.c:2406-2424``, where the per-pixel pointer reaches the final
    storage directly).

    Screen pixel ``p`` reads lensmap texel ``t = flat_idx[p]``, and the
    ingest resamples ``t`` from pano taps ``(idx[k, t], w[k, t])``, so the
    composed tables are ``idx[:, flat_idx]`` / ``w[:, flat_idx]`` with shape
    ``[K, H*W]``, made on the remap's device from the tables already there
    (a device-built lensmap's ``flat_idx`` never visits the host).  Per batch
    this is one launch of K10 with its screen epilogue: K x H*W pano rows
    gathered and blended, the rubix tint, the background select, and no
    faces in between.  The per-pixel blend runs the identical float32
    arithmetic on the identical taps the face texel would have received, so
    outputs are bit-equal to the two-stage chain.

    Keep the two-stage path (`EquirectIngest` + `RemapKernel`) when one
    ingest feeds SEVERAL lenses: faces are computed once there, while this
    kernel re-resamples per lens.

    ``remap``: a :class:`blinky_tpu_torch.kernels.remap.RemapKernel`; its
    lensmap picks the composition, and its validity, background and tint
    operands are reused in place.
    """

    @spanned("build.screen_kernel")
    def __init__(self, ingest: EquirectIngest, remap):
        _check_composition(
            ingest, remap,
            "compose from the FULL-layout EquirectIngest: the fused "
            "kernel is already the ultimate texel compaction")
        lm = remap.lensmap
        idx, w, _ = ingest.device_tables()
        t = remap.flat_idx.long()
        self.idx = idx.index_select(1, t)  # [K, H*W]
        self.w = w.index_select(1, t) if ingest.bilinear else None
        self.remap = remap
        self.device = remap.device
        self.pano_hw = ingest.pano_hw
        self.bilinear = ingest.bilinear
        self.shape = (lm.height_px, lm.width_px)

    def __call__(self, panos, rubix=False):
        """[H, W, B] u32 panos -> [H_out, W_out, B] ``torch.uint32``
        screens on the remap's device."""
        src = panos_bits(panos, self.pano_hw, self.device)
        tr, tm = self.remap.tint_rgb_mask if rubix else (None, None)
        out = equirect_gather(src, self.idx, self.w, valid=self.remap.valid,
                              bg=self.remap.background_rgba, tint_rgb=tr,
                              tint_mask=tm)
        return out.reshape(self.shape + (src.shape[1],)).view(torch.uint32)


class CompactEquirectChain:
    """Texel-compacted two-stage pano -> screen.

    Stage 1 resamples ONLY the texels the lensmap references, in sorted
    texel order (:meth:`EquirectIngest.subset` of ``compact_texels``' unique
    set; K10 with its plate mask); stage 2 is the compacted remap gather
    (K1, with the tint operands when rubix).  The faces intermediate is the
    ``[R, B]`` rows of those texels only.  Same ``__call__(panos, rubix=)``
    contract as the fused kernel; bit-equal to both other forms.  The
    compaction runs once, on the host (a device-built lensmap is copied
    there for it).
    """

    @spanned("build.compact_chain")
    def __init__(self, ingest: EquirectIngest, remap):
        _check_composition(
            ingest, remap,
            "pass the FULL-layout EquirectIngest: the chain derives its "
            "own texel subset")
        lm = remap.lensmap
        texels, cidx = compact_texels(lm.to_numpy())
        self.sub = ingest.subset(texels)
        self.cidx = torch.from_numpy(cidx.reshape(-1)).to(remap.device)
        self.remap = remap
        self.device = remap.device
        self.pano_hw = ingest.pano_hw
        self.bilinear = ingest.bilinear
        self.shape = (lm.height_px, lm.width_px)

    def __call__(self, panos, rubix=False):
        """[H, W, B] u32 panos -> [H_out, W_out, B] ``torch.uint32``
        screens on the remap's device."""
        sub = self.sub.gather_bits(panos)  # [R, B], sorted texel order
        tr, tm = self.remap.tint_rgb_mask if rubix else (None, None)
        out = remap_gather(sub, self.cidx, self.remap.valid,
                           self.remap.background_rgba, tint_rgb=tr, tint_mask=tm)
        return out.reshape(self.shape + (sub.shape[1],)).view(torch.uint32)
