"""Multi-device scale-out: frame data parallelism and screen-row blocks.

The port of :mod:`blinky_tpu.parallel`.  The JAX package lays its devices
out on a ``("data", "space")`` mesh (``("slice", "data", "space")`` for
two levels) and lets XLA's partitioner split each step:

* frames ``[P, S, S, B]`` split on ``B`` over the data axes: the remap is
  independent across frames, so the only traffic is the input going out
  to the devices and the output coming back;
* the lensmap's ``[H, W]`` arrays split on ``H`` over "space": each device
  gathers only its own screen rows from a source it holds whole.

Here a :class:`Mesh` is an array of ``torch.device`` with axis names, and
the split is written out: each mesh cell's device gets its lanes of the
frames and a copy of the remap operands that holds only its row block,
and runs the same hand-written kernels as one card does (K1 and K2 for
the remap, K8 for the build, K7 and K6 for the posed paths, K10 for the
equirect paths) on its own tensors.  No collective and no copy between
devices happens inside a step.  What a sharded function returns is a
:class:`ShardedArray`, whose pieces stay on their devices until the caller
assembles them on the host (``np.asarray``) or on one device (``.to``).

A mesh may name one device several times.  Its cells are then logical
shards of that device: the same split and the same per-cell launches, run
one after the other.  That is how the tests exercise the split on the CPU
(``[torch.device("cpu")] * 8``, the counterpart of the JAX package's 8
virtual CPU devices) and how one card runs a (4, 2) mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import functools

import numpy as np
import torch

from blinky_tpu_torch.kernels.ingest import EquirectScreenKernel, panos_bits
from blinky_tpu_torch.kernels.posed import PosedRemapKernel
from blinky_tpu_torch.kernels.remap import (
    RemapKernel, frames_tensor, remap_gather, remap_lut,
)
from blinky_tpu_torch.kernels.static_ray import StaticRayPosedKernel, ray_table_from_lens
from blinky_tpu_torch.palette import MAX_PLATES


# ------------------------------------------------------------------ meshes


class Mesh:
    """An ndarray of ``torch.device`` with one name a dimension: the JAX
    package's ``jax.sharding.Mesh`` as its callers read it (``.devices``,
    ``.devices.size``, ``.axis_names``, ``.shape``)."""

    def __init__(self, devices, axis_names):
        devs = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            devs[i] = _indexed(d)
        if devs.ndim != len(axis_names):
            raise ValueError(f"{devs.ndim}-d devices for axes {tuple(axis_names)}")
        self.devices = devs
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))


def _indexed(device) -> torch.device:
    """*device* with its index: ``cuda`` names the current card, which is
    what a tensor made there reports (``cuda:0``), and pieces are found by
    their tensors' devices."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices(kind: str = "cuda") -> list:
    """The devices a mesh takes by default: ``cuda:0 .. cuda:{n-1}`` for
    *kind* "cuda", raising when there is no card; ``[cpu]`` for "cpu"."""
    if kind == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for a mesh: pass devices=[...] (for the CPU, "
            "[torch.device('cpu')] * n gives n logical shards)")
    return [torch.device("cuda", i) for i in range(n)]


def _device_array(devices) -> np.ndarray:
    devs = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    out = np.empty(len(devs), dtype=object)
    out[:] = devs
    return out


def make_mesh(n_data: int | None = None, n_space: int = 1, devices=None) -> Mesh:
    """A ("data", "space") mesh of the first ``n_data * n_space`` devices
    (by default every card there is; a list may repeat a device, whose
    cells are then logical shards of it)."""
    devs = _device_array(devices)
    if n_data is None:
        n_data = devs.size // n_space
    n = n_data * n_space
    if n > devs.size:
        raise ValueError(f"need {n} devices, have {devs.size}")
    return Mesh(devs[:n].reshape(n_data, n_space), ("data", "space"))


def make_slice_mesh(n_slice: int, n_data: int | None = None,
                    n_space: int = 1, devices=None) -> Mesh:
    """A two-level ("slice", "data", "space") mesh, slice-major: the batch
    splits over slice x data (:func:`data_axes`), the remap operands over
    "space" and are replicated across slices, as in the JAX package."""
    devs = _device_array(devices)
    if n_data is None:
        n_data = devs.size // (n_slice * n_space)
    n = n_slice * n_data * n_space
    if n > devs.size:
        raise ValueError(f"need {n} devices, have {devs.size}")
    return Mesh(devs[:n].reshape(n_slice, n_data, n_space),
                ("slice", "data", "space"))


def data_axes(mesh: Mesh):
    """The mesh axes a batch dimension splits over: ``("slice", "data")``
    on a two-level mesh, ``("data",)`` otherwise."""
    return tuple(a for a in ("slice", "data") if a in mesh.axis_names)


def _cells(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as [lane groups, row blocks]: the data axes
    flattened (slice-major), "space" last."""
    n_space = mesh.shape.get("space", 1)
    return mesh.devices.reshape(-1, n_space)


def _blocks(n: int, parts: int) -> list:
    """*n* split into *parts* contiguous ranges, the first ones a unit
    longer when it does not divide."""
    q, r = divmod(n, parts)
    edges = np.cumsum([0] + [q + (i < r) for i in range(parts)])
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def _lanes(B: int, groups: int) -> list:
    if B % groups:
        raise ValueError(f"a batch of {B} does not split evenly over {groups} "
                         "data shards")
    return _blocks(B, groups)


def lane_shards(mesh: Mesh, B: int):
    """``(b0, b1, device)`` for every data shard's lanes and every distinct
    device of its row of the mesh: where a batch split over the data axes
    goes (the row's cells on one device share its lanes).  A B that does
    not split evenly raises."""
    cells = _cells(mesh)
    for g, (b0, b1) in enumerate(_lanes(B, cells.shape[0])):
        for dev in dict.fromkeys(cells[g]):
            yield b0, b1, dev


def per_device(owner, mesh: Mesh, make) -> dict:
    """``{device: make(device)}`` for the distinct devices of *mesh*, made
    once per (owner, mesh) and kept in ``owner._sharded_for``: the static
    operands a sharded function replicates are not copied again a call."""
    cached = getattr(owner, "_sharded_for", None)
    if cached is not None and cached[0] is mesh:
        return cached[1]
    copies = {dev: make(dev) for dev in dict.fromkeys(mesh.devices.flat)}
    owner._sharded_for = (mesh, copies)
    return copies


# ----------------------------------------------------------- sharded arrays


class ShardedArray:
    """A global array held as pieces on their devices: ``pieces`` is a list
    of ``(index, tensor)``, *index* a tuple of slices into the global
    shape.  Pieces may repeat a region (replicas).  Stands in for the JAX
    package's globally sharded ``jax.Array``: ``device_set`` is its
    ``.sharding.device_set``, ``np.asarray`` and :meth:`numpy` assemble on
    the host, :meth:`to` on one device."""

    def __init__(self, shape, dtype, pieces):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.pieces = list(pieces)

    @property
    def device_set(self) -> set:
        return {t.device for _, t in self.pieces}

    def piece(self, index, device):
        """The tensor of the piece at *index* on *device*, or None."""
        device = _indexed(device)
        for idx, t in self.pieces:
            if idx == index and t.device == device:
                return t
        return None

    def to(self, device) -> torch.Tensor:
        """The whole array as one tensor on *device* (``torch.uint32``
        arrays assemble through their int32 bits)."""
        bits = self.dtype == torch.uint32
        out = torch.empty(self.shape, dtype=torch.int32 if bits else self.dtype,
                          device=device)
        for idx, t in self.pieces:
            out[idx] = t.view(torch.int32) if bits else t
        return out.view(torch.uint32) if bits else out

    def numpy(self) -> np.ndarray:
        out = self.to("cpu")
        if out.dtype == torch.uint32:
            return out.view(torch.int32).numpy().view(np.uint32)
        return out.numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)


def _region(a, index, device) -> torch.Tensor:
    """``a[index]`` (a tensor, a NumPy array or a :class:`ShardedArray`) as
    a contiguous tensor on *device*: a piece already there with exactly
    that region is handed out as it is."""
    if isinstance(a, ShardedArray):
        t = a.piece(index, torch.device(device))
        if t is not None:
            return t
        a = a.to(device)
    if isinstance(a, torch.Tensor):
        return a[index].to(device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[index])).to(device)


# ----------------------------------------------------------- the lensmap


def _row_lensmap(lm, r0: int, r1: int, device):
    """Rows r0..r1 of a lensmap, its [H, W] arrays as tensors on *device*
    (``flat_idx`` keeps its values: it indexes the whole source)."""
    rows = (slice(r0, r1), slice(0, lm.width_px))
    fields = {f: _region(getattr(lm, f), rows, device)
              for f in ("plate", "px", "py", "valid", "tint", "flat_idx")}
    return dataclasses.replace(lm, height_px=r1 - r0, **fields)


def _row_kernel(kernel: RemapKernel, r0: int, r1: int, device) -> RemapKernel:
    """A copy of *kernel* that holds screen rows r0..r1 on *device*: its
    lensmap's row slice and background rows, the palette's tables
    replicated, and no post-gather tint cache (the copy makes its own from
    its rows)."""
    lm = kernel.lensmap
    bg = np.asarray(kernel.background_np).reshape(lm.height_px, lm.width_px)[r0:r1]
    k = RemapKernel(_row_lensmap(lm, r0, r1, device), kernel.palette, bg, device=device)
    if kernel._tint_lut is not None:
        k._tint_lut = kernel._tint_lut.to(device)
    return k


def shard_kernel(kernel: RemapKernel, mesh: Mesh) -> np.ndarray:
    """Copies of *kernel* for the mesh's cells, shaped like
    ``mesh.devices``: each holds only its cell's screen-row block (the
    rows split over "space"), on its cell's device.  Cells of one row
    block on one device share a copy.  The caller's kernel is left as it
    is."""
    cells = _cells(mesh)
    rows = _blocks(kernel.height_px, cells.shape[1])
    made = {}
    out = np.empty(cells.shape, dtype=object)
    for (g, s), dev in np.ndenumerate(cells):
        key = (s, dev)
        if key not in made:
            made[key] = _row_kernel(kernel, *rows[s], dev)
        out[g, s] = made[key]
    return out.reshape(mesh.devices.shape)


def build_lensmap_sharded(lens, globe, scale, width_px, height_px, mesh,
                          platesize=None, numcells=10, cell_size=4.0,
                          pad_size=1.0, dtype=None, view_basis=None):
    """The float32 device build with its rows split over "space": each
    cell's device runs the lens stage over its own screen rows only
    (``lens_ray_grid(..., row_range=(r0, r1))``), then K8
    (``lensmap_resolve``) on them.  Returns a ``LensMap`` whose [H, W]
    arrays are :class:`ShardedArray` row blocks (ready for
    :func:`remap_sharded` with no copy) and whose ``plates_used`` is the
    OR of the blocks', on every device."""
    from blinky_tpu_torch.lensmap.builder import (
        IDENTITY_BASIS, LensMap, lens_rays_torch, lensmap_resolve,
    )

    if platesize is None:
        platesize = min(width_px, height_px)
    if lens.map_type != "inverse":
        raise ValueError("sharded builds support inverse lenses (forward "
                         "lenses rasterize on the host)")
    if dtype not in (None, torch.float32):
        raise ValueError(f"the device builder builds in float32, not {dtype}")
    basis = IDENTITY_BASIS if view_basis is None else view_basis
    cells = _cells(mesh)
    rows = _blocks(height_px, cells.shape[1])
    pieces = {f: [] for f in ("plate", "px", "py", "valid", "tint", "flat_idx")}
    used = []
    for s, dev in sorted({(s, d) for (_, s), d in np.ndenumerate(cells)},
                         key=lambda sd: (sd[0], str(sd[1]))):
        r0, r1 = rows[s]
        rays = lens_rays_torch(lens, scale, width_px, height_px, dev, row_range=(r0, r1))
        out = lensmap_resolve(globe, *rays, platesize, numcells, cell_size, pad_size, basis)
        for f in pieces:
            pieces[f].append(((slice(r0, r1), slice(0, width_px)), out[f]))
        used.append(out["plates_used"])
    plates_used = functools.reduce(torch.logical_or, (u.cpu() for u in used))
    devices = sorted(set(cells.flat), key=str)
    arrays = {f: ShardedArray((height_px, width_px), p[0][1].dtype, p)
              for f, p in pieces.items()}
    arrays["plates_used"] = ShardedArray(
        (MAX_PLATES,), torch.bool,
        [((slice(0, MAX_PLATES),), plates_used.to(d)) for d in devices])
    return LensMap(width_px=width_px, height_px=height_px, platesize=platesize,
                   numplates=globe.numplates, scale=float(scale), **arrays)


# ------------------------------------------------------------------ frames


def shard_frames(frames, mesh: Mesh) -> ShardedArray:
    """A [NP, S, S, B] batch (u8 indices or u32 RGBA; NP may be the
    expanded 12) with B split over the data axes: each data shard's
    ``B / n`` lanes, contiguous, on every device of its row of the mesh
    (once a device).  A B that does not split evenly raises."""
    t, is_rgba = frames_tensor(frames)
    rest = tuple(slice(0, n) for n in t.shape[:-1])
    pieces = [(rest + (slice(b0, b1),), t[..., b0:b1].to(dev).contiguous())
              for b0, b1, dev in lane_shards(mesh, t.shape[-1])]
    return ShardedArray(t.shape, torch.uint32 if is_rgba else torch.uint8,
                        [(i, p.view(torch.uint32) if is_rgba else p) for i, p in pieces])


def _frames_piece(frames: ShardedArray, g: int, lanes, device):
    b0, b1 = lanes[g]
    index = tuple(slice(0, n) for n in frames.shape[:-1]) + (slice(b0, b1),)
    return frames.piece(index, device)


# ------------------------------------------------------------------- remap


def remap_sharded(kernel: RemapKernel, frames, mesh: Mesh, rubix: bool = False,
                  decode_rgb: bool = False) -> ShardedArray:
    """The remap with the frames split on B over the data axes and the
    screen rows over "space": each cell gathers its rows of its lanes on
    its device.  The expanded (raw||tinted) and RGBA sources take the pure
    gather (K1, clip rule), an expanded decode K2 after it; a plain u8
    source takes K1 (fill rule), or K2 for rubix or the RGB decode, as
    ``blinky_tpu.parallel.remap_sharded`` does (no zero-padding of a short
    source).  The row copies of the kernel are made once per (kernel,
    mesh) and kept in ``kernel._sharded_for``."""
    sframes = shard_frames(frames, mesh)
    cached = getattr(kernel, "_sharded_for", None)
    if cached is not None and cached[0] is mesh:
        copies = cached[1]
    else:
        copies = shard_kernel(kernel, mesh)
        kernel._sharded_for = (mesh, copies)
    expanded = sframes.shape[0] == 2 * MAX_PLATES
    is_rgba = sframes.dtype == torch.uint32
    if expanded or is_rgba:
        if rubix and not expanded:
            raise ValueError("rubix on an RGBA source needs the expanded layout")
        if decode_rgb and not is_rgba and kernel.rgb_lut is None:
            raise ValueError("RGB decode needs a palette")
    elif (rubix and kernel.tint_lut is None) or (decode_rgb and kernel.rgb_lut is None):
        raise ValueError("remap_sharded needs a palette for rubix/RGB decode")
    cells = _cells(mesh)
    copies = copies.reshape(cells.shape)
    B = sframes.shape[-1]
    lanes = _lanes(B, cells.shape[0])
    rows = _blocks(kernel.height_px, cells.shape[1])
    decoded = decode_rgb and not is_rgba
    pieces = []
    for (g, s), dev in np.ndenumerate(cells):
        k = copies[g, s]
        part = _frames_piece(sframes, g, lanes, dev)
        src = (part.view(torch.int32) if is_rgba else part).reshape(-1, part.shape[-1])
        if expanded or is_rgba:
            idx = k.flat_idx_rubix if (rubix and expanded) else k.flat_idx
            bg = k.background_rgba if is_rgba else k.background
            if decoded:
                out = remap_lut(src, idx, k.valid, k.tint, bg, rgb_lut=k.rgb_lut,
                                fill=False)
            else:
                out = remap_gather(src, idx, k.valid, bg)
        elif rubix or decode_rgb:
            out = remap_lut(src, k.flat_idx, k.valid, k.tint, k.background,
                            k.tint_lut if rubix else None,
                            k.rgb_lut if decode_rgb else None, fill=True)
        else:
            out = remap_gather(src, k.flat_idx, k.valid, k.background, fill=True)
        out = out.reshape((k.height_px, k.width_px) + tuple(out.shape[1:]))
        index = (slice(*rows[s]), slice(0, k.width_px), slice(*lanes[g]))
        pieces.append((index + ((slice(0, 3),) if decoded else ()),
                       out.view(torch.uint32) if is_rgba else out))
    shape = (kernel.height_px, kernel.width_px, B) + ((3,) if decoded else ())
    return ShardedArray(shape, torch.uint32 if is_rgba else torch.uint8, pieces)


def ingest_equirect_sharded(ingest, panos, mesh: Mesh) -> ShardedArray:
    """An ``EquirectIngest`` with the pano batch (``[H, W, B]`` u32) split
    on B over the data axes: each device resamples its lanes through K10
    with the ingest's tables replicated there.  The faces ``[P, S, S, B]``
    come back split on B, ready for :func:`remap_sharded`."""
    src = panos_bits(panos, ingest.pano_hw, panos.device if isinstance(
        panos, torch.Tensor) else "cpu")
    B = src.shape[1]

    def make(dev):
        c = copy.copy(ingest)
        c.device = dev
        c._device_tables = tuple(t.to(dev) for t in ingest.device_tables())
        return c

    copies = per_device(ingest, mesh, make)
    pieces = []
    for b0, b1, dev in lane_shards(mesh, B):
        part = src[:, b0:b1].to(dev).contiguous()
        faces = copies[dev](part.view(torch.uint32).reshape(ingest.pano_hw + (b1 - b0,)))
        pieces.append((tuple(slice(0, n) for n in faces.shape[:-1]) + (slice(b0, b1),),
                       faces))
    return ShardedArray(tuple(pieces[0][1].shape[:-1]) + (B,), torch.uint32, pieces)


def equirect_screen_sharded(kernel: EquirectScreenKernel, panos, mesh,
                            rubix=False):
    """The fused pano -> screen kernel with the pano batch (``[H, W, B]``
    u32, batch-innermost) split on B over the mesh's data axes: the
    composed tables and the screen's operands replicated on every device
    of the mesh (once per (kernel, mesh)), each shard's lanes through K10
    there.  Returns a :class:`blinky_tpu_torch.parallel.ShardedArray`
    ``[H_out, W_out, B]`` of ``torch.uint32``, bit-equal to
    ``kernel(panos, rubix=rubix)``."""
    src = panos_bits(panos, kernel.pano_hw, panos.device if isinstance(
        panos, torch.Tensor) else "cpu")
    B = src.shape[1]

    def make(dev):
        c = copy.copy(kernel)
        c.device = dev
        c.idx = kernel.idx.to(dev)
        c.w = None if kernel.w is None else kernel.w.to(dev)
        c.remap = _row_kernel(kernel.remap, 0, kernel.shape[0], dev)
        return c

    shards = list(lane_shards(mesh, B))
    copies = per_device(kernel, mesh, make)
    H, W = kernel.shape
    pieces = []
    for b0, b1, dev in shards:
        part = src[:, b0:b1].to(dev).contiguous()
        out = copies[dev](part.view(torch.uint32).reshape(kernel.pano_hw + (b1 - b0,)),
                          rubix=rubix)
        pieces.append(((slice(0, H), slice(0, W), slice(b0, b1)), out))
    return ShardedArray((H, W, B), torch.uint32, pieces)


# ------------------------------------------------------------------- poses


def posed_remap_sharded(kernel: PosedRemapKernel, frames, bases, mesh):
    """The per-frame-pose pipeline with the POSE axis split over the mesh's
    data axes: each data shard's poses and their frames go to the devices
    of its row of the mesh, where the float32 lens stage runs once (the
    ray table of that device's copy of *kernel*, made once per (kernel,
    mesh)) and every call is K7 and K6 there.  Returns a
    :class:`blinky_tpu_torch.parallel.ShardedArray` ``[B, H, W]``, bit-equal
    to ``kernel(frames, bases)``."""

    def table(dev):
        k = kernel.render_scale
        return ray_table_from_lens(kernel.lens, kernel.scale * k, kernel.width_px // k,
                                   kernel.height_px // k, backend="torch", device=dev)

    return _posed_sharded(kernel, kernel._static, frames, bases, mesh, table)


def static_ray_posed_sharded(kernel: StaticRayPosedKernel, frames, bases, mesh):
    """The static-ray posed pipeline with the POSE axis split over the
    mesh's data axes: the ray table replicated on every device of the mesh
    (once per (kernel, mesh)), each data shard's poses and frames on the
    devices of its row, K7 and K6 there.  Returns a
    :class:`blinky_tpu_torch.parallel.ShardedArray` ``[B, H, W]``, bit-equal
    to ``kernel(frames, bases)``."""
    return _posed_sharded(kernel, kernel, frames, bases, mesh,
                          lambda dev: kernel.ray_table)


def _posed_sharded(owner, kernel, frames, bases, mesh, table):
    """The pose split of :func:`posed_remap_sharded` and
    ``static_ray_posed_sharded``: *kernel*, a ``StaticRayPosedKernel``,
    copied once per device of the mesh with ``table(device)`` as its ray
    table and the background replicated (cached in ``owner._sharded_for``),
    then called on each data shard's lanes on each device of its row (a
    shard on its own kernel's device is handed over as a lane slice, which
    K7 lays out in place)."""
    frames, is_rgba = frames_tensor(frames)
    B = frames.shape[-1]
    bases = np.asarray(bases) if not isinstance(bases, torch.Tensor) else bases
    if tuple(bases.shape) != (B, 3, 3):
        raise ValueError(f"bases must be [B={B}, 3, 3], got {tuple(bases.shape)}")

    def make(dev):
        c = copy.copy(kernel)
        c.device = dev
        c.ray_table = table(dev).device(dev)
        c.background = kernel.background.to(dev)
        return c

    shards = list(lane_shards(mesh, B))
    copies = per_device(owner, mesh, make)
    pieces = []
    for b0, b1, dev in shards:
        part = frames[..., b0:b1]
        if part.device != dev:
            part = part.to(dev).contiguous()
        out = copies[dev](part.view(torch.uint32) if is_rgba else part, bases[b0:b1])
        pieces.append(((slice(b0, b1),) + tuple(slice(0, n) for n in out.shape[1:]), out))
    return ShardedArray((B,) + tuple(pieces[0][1].shape[1:]), pieces[0][1].dtype, pieces)
