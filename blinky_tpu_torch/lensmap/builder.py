"""Lensmap builders: the exact float64 host path and the float32 device
path.

Reference: ``create_lensmap`` (``engine/NQ/fisheye.c:2367-2397``) and the
inverse scan ``resume_lensmap_inverse`` (``fisheye.c:2084-2124``).

* ``build_lensmap(backend="numpy")`` is :mod:`blinky_tpu.lensmap.builder`'s
  NumPy float64 branch (glibc libm via :mod:`blinky_tpu_torch.xmath`); it
  bit-equals the JAX package's ``build_lensmap(backend="numpy")``.
* ``build_lensmap(backend="torch")`` is the counterpart of its jitted
  float32 builder: the lens stage (:func:`lens_ray_grid`, the generic lens
  code as eager tensor operations on the device) and then the resolve,
  :func:`lensmap_resolve`: K8, the hand-written CUDA kernel
  ``blinky_lensmap_resolve`` (``csrc/lensmap.cu``), for tensors on a card, and
  its plain version :func:`rays_to_lensmap_torch` for tensors on the CPU.
  A rebuild costs milliseconds there, which is what a pose-tracked view and
  a zoom sweep need; its tables differ from the exact ones at a few boundary
  texels.

A forward-mapped lens has no inverse to evaluate: whatever the backend,
:func:`build_lensmap` rasterizes it on the host
(:func:`blinky_tpu_torch.lensmap.forward_raster.build_forward`, NumPy
float64 and the native quad fill), as the JAX package does, and returns
NumPy tables.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from blinky_tpu_torch import geometry
from blinky_tpu_torch import xmath as m
from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.globes import Globe
from blinky_tpu_torch.lenses import LensDef
from blinky_tpu_torch.palette import MAX_PLATES
from blinky_tpu_torch.utils.timing import spanned

# tint-plane value meaning "no tint" in the compact 7-row LUT space
# (the reference stores 255, fisheye.c:732; we use row 6 of the tint LUT).
TINT_NONE = MAX_PLATES

_FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")


@dataclasses.dataclass
class LensMap:
    """The built gather table ([H, W] arrays in screen row-major order:
    NumPy arrays from the host builder, tensors on the build's device from
    the float32 builder).

    ``flat_idx`` indexes the flattened ``[MAX_PLATES, S, S]`` globe store:
    ``plate * S*S + py * S + px`` (the reference's per-pixel pointers,
    ``LENSPIXEL``, ``fisheye.c:430``).
    """

    width_px: int
    height_px: int
    platesize: int
    numplates: int
    scale: float
    plate: np.ndarray  # int32 [H, W], -1 where invalid
    px: np.ndarray  # int32 [H, W]
    py: np.ndarray  # int32 [H, W]
    valid: np.ndarray  # bool [H, W]
    tint: np.ndarray  # uint8 [H, W]; 0..5 plate tint, TINT_NONE = none
    flat_idx: np.ndarray  # int32 [H, W]
    plates_used: np.ndarray  # bool [MAX_PLATES] — the reference's display flags

    def to_torch(self, device) -> dict:
        """The table's arrays as tensors on *device*, keyed by field (a
        tensor already there is handed out as it is)."""
        return {f: _as_tensor(getattr(self, f)).to(device) for f in _FIELDS}

    def to_numpy(self) -> "LensMap":
        """The same table with NumPy arrays (a copy to the host for a table
        built on a card)."""
        return dataclasses.replace(self, **{
            f: (a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a))
            for f in _FIELDS for a in [getattr(self, f)]})

    @property
    def tint_c(self):
        """The tint plane in the reference's encoding (255 = no tint)."""
        if isinstance(self.tint, torch.Tensor):
            return torch.where(self.tint == TINT_NONE, 255, self.tint).to(torch.uint8)
        return np.where(self.tint == TINT_NONE, np.uint8(255), self.tint.astype(np.uint8))


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))


def rubix_grid_mask(px, py, platesize, numcells, cell_size, pad_size):
    """True where the plate pixel lies on the rubix grid *lines* (untinted).

    Transcribes ``set_lensmap_grid`` (``fisheye.c:1922-1960``): the plate is
    divided into ``numcells`` blocks of ``cell_size`` units with
    ``pad_size`` units of padding; a pixel is on the grid when its unit
    coordinate falls in the padding band along either axis.  In IEEE
    doubles, like the C: ``f_rubixgrid 0 0 0`` divides by zero to inf
    (-> no grid lines) rather than failing.
    """
    block_size = pad_size + cell_size
    num_units = numcells * block_size + pad_size
    with np.errstate(divide="ignore", invalid="ignore"):
        unit_size_px = np.asarray(platesize, dtype=np.float64) / np.asarray(
            num_units, dtype=np.float64)
        ux = px / unit_size_px
        uy = py / unit_size_px
        return (np.fmod(ux, block_size) < pad_size) | (
            np.fmod(uy, block_size) < pad_size)


def lens_ray_grid(lens, scale, width_px, height_px, xp=np, dtype=np.float64,
                  device=None, row_range=None):
    """The pose-invariant half of the inverse build: pixel grid ->
    pre-rotation camera-frame ray (``resume_lensmap_inverse``,
    ``fisheye.c:2084-2124``): screen -> lens plane (note the C integer
    division ``width_px/2``), then ``lens_inverse`` -> unnormalized
    camera-frame ray + validity.  This is the only stage that touches lens
    math: the ray grid depends only on (lens, zoom scale, size).

    *xp*, *dtype*: the array namespace and the build dtype, ``np`` and
    float64 for the exact host build, ``torch`` and ``torch.float32`` on
    *device* for the float32 builder.  There *scale* becomes a 0-d tensor of
    the build dtype on the device (a NumPy scalar times a tensor would
    dispatch to NumPy); a 1-d *scale* of N zoom steps gives [N, H, W] grids,
    the zoom sweep's.  ``row_range=(r0, r1)`` computes only screen rows
    ``r0..r1``.

    Returns ``(vx, vy, vz, lens_valid)`` with ``lens_valid`` broadcast to
    the grid shape (ray components keep whatever broadcast shape the lens
    emitted).
    """
    half_w = width_px // 2  # C int division, fisheye.c:2105
    half_h = height_px // 2  # fisheye.c:2100
    r0, r1 = (0, height_px) if row_range is None else row_range
    shape = (r1 - r0, width_px)
    if xp is torch:
        scale = torch.as_tensor(scale, dtype=dtype, device=device)
        lx = torch.arange(width_px, dtype=torch.int32, device=device)
        ly = torch.arange(r0, r1, dtype=torch.int32, device=device)
        shape = tuple(scale.shape) + shape  # [N] zoom steps -> [N, H, W]
        x = ((lx - half_w).to(dtype) * scale[..., None])[..., None, :]
        y = (-(ly - half_h).to(dtype) * scale[..., None])[..., :, None]
        X = torch.broadcast_to(x, shape)
        Y = torch.broadcast_to(y, shape)
        vx, vy, vz, lens_valid = lens.inverse(X, Y)
        lens_valid = torch.broadcast_to(
            torch.as_tensor(lens_valid, device=X.device), shape)
        return vx, vy, vz, lens_valid
    scale = np.asarray(scale, dtype=dtype)

    lx = np.arange(width_px, dtype=np.int32)
    ly = np.arange(r0, r1, dtype=np.int32)
    x = ((lx - half_w).astype(dtype) * scale)[None, :]
    y = (-(ly - half_h).astype(dtype) * scale)[:, None]
    X = np.broadcast_to(x, shape)
    Y = np.broadcast_to(y, shape)

    vx, vy, vz, lens_valid = lens.inverse(X, Y)
    lens_valid = np.broadcast_to(np.asarray(lens_valid), shape)
    return vx, vy, vz, lens_valid


@spanned("lensmap.lens_stage")
def lens_rays_torch(lens, scale, width_px, height_px, device, dtype=torch.float32,
                    row_range=None):
    """The float32 lens stage as the kernels take it: :func:`lens_ray_grid`
    on *device*, each ray plane broadcast to the grid, cast to float32 and
    made contiguous, with the bool mask.  [H, W], or [N, H, W] for a 1-d
    *scale*; ``row_range=(r0, r1)`` computes screen rows r0..r1 only."""
    vx, vy, vz, lens_valid = lens_ray_grid(lens, scale, width_px, height_px, torch,
                                           dtype, device, row_range=row_range)
    shape = lens_valid.shape
    planes = tuple(torch.broadcast_to(torch.as_tensor(v, device=lens_valid.device), shape)
                   .to(torch.float32).contiguous() for v in (vx, vy, vz))
    return (*planes, lens_valid.to(torch.bool).contiguous())


def rays_to_lensmap(globe, vx, vy, vz, lens_valid, platesize,
                    numcells, cell_size, pad_size, view_basis=None):
    """The lens-independent half of the inverse build: camera-frame rays
    -> gather table.

    Rotate (optional ``view_basis``) -> f32 normalize (``fisheye.c:1562``)
    -> plate by max-dot or custom resolver -> plate uv -> truncated pixel
    coords with bounds rejection (``fisheye.c:1963-1992``) -> tint via
    the rubix grid.

    ``view_basis``: optional (forward, right, up) 3-vectors rotating the
    view within recorded plates: ``ray' = rx*right + ry*up + rz*forward``.
    """
    S = platesize
    f64 = np.float64
    if view_basis is not None:
        fwd_v, rgt_v, up_v = (np.asarray(v, dtype=f64) for v in view_basis)
        vx, vy, vz = (
            vx * rgt_v[0] + vy * up_v[0] + vz * fwd_v[0],
            vx * rgt_v[1] + vy * up_v[1] + vz * fwd_v[1],
            vx * rgt_v[2] + vy * up_v[2] + vz * fwd_v[2],
        )

    # The reference stores the lens ray and the plate frames as vec_t =
    # float32 while the lens math is double (LUAtoC_lens_inverse,
    # fisheye.c:1545-1565; struct plates, fisheye.c:354-358) — emulate that
    # boundary exactly.
    f32 = np.float32
    vx32, vy32, vz32 = geometry.normalize_c(
        np.asarray(vx).astype(f32), np.asarray(vy).astype(f32),
        np.asarray(vz).astype(f32), np, f32, f64,
    )

    # Plate selection + plate-frame dots as an unrolled strict-> running
    # max (ray_to_plate_index's first-max-wins scan, fisheye.c:2043) and
    # where-chains, with the float32 DotProduct order of fisheye.c:2052-2058.
    fwd = np.asarray(globe.forward)
    rgt = np.asarray(globe.right)
    up = np.asarray(globe.up)
    n = globe.numplates

    def dot3(vecs, k):  # f32 DotProduct with plate k's stored vec_t frame
        return vx32 * vecs[k, 0] + vy32 * vecs[k, 1] + vz32 * vecs[k, 2]

    dF = [dot3(fwd, k) for k in range(n)]

    if globe.plate_resolver is not None:
        # the Lua resolver computes in double on the promoted f32 ray
        # (LUAtoC_globe_plate, fisheye.c:1634-1656)
        plate = globe.plate_resolver(
            vx32.astype(f64), vy32.astype(f64), vz32.astype(f64), globe
        )
        plate = np.asarray(plate).astype(np.int32)
        pc = np.clip(plate, 0, n - 1)
    else:
        best = dF[0]
        pc = np.zeros_like(best, dtype=np.int32)
        for k in range(1, n):
            m_k = dF[k] > best  # strict >: first maximum wins; NaN keeps 0
            best = np.where(m_k, dF[k], best)
            pc = np.where(m_k, np.int32(k), pc)
        plate = pc

    # frame dots of the selected plate (ray_to_plate_uv, fisheye.c:2052-2058)
    rz32 = dF[0]
    rx32 = dot3(rgt, 0)
    ry32 = dot3(up, 0)
    for k in range(1, n):
        sel = pc == k
        rz32 = np.where(sel, dF[k], rz32)
        rx32 = np.where(sel, dot3(rgt, k), rx32)
        ry32 = np.where(sel, dot3(up, k), ry32)

    # dist recomputed in double from the f32-stored fov (fisheye.c:2060)
    dists = [0.5 / math.tan(float(globe.fov_rad[k]) / 2) for k in range(n)]
    dist = np.asarray(dists[0], dtype=f64)
    for k in range(1, n):
        dist = np.where(pc == k, np.asarray(dists[k], dtype=f64), dist)

    rx = rx32.astype(f64)
    ry = ry32.astype(f64)
    rz = rz32.astype(f64)
    u = m.safe_div(rx, rz) * dist + 0.5
    v = m.safe_div(-ry, rz) * dist + 0.5
    uv_valid = (rz != 0) & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)

    u = np.where(uv_valid, u, 0.0)
    v = np.where(uv_valid, v, 0.0)
    px = (u * S).astype(np.int32)  # C truncation cast, fisheye.c:1988
    py = (v * S).astype(np.int32)
    in_bounds = (px >= 0) & (px < S) & (py >= 0) & (py < S)  # fisheye.c:1971

    valid = lens_valid & (plate >= 0) & uv_valid & in_bounds

    ongrid = rubix_grid_mask(px, py, S, numcells, cell_size, pad_size)
    tint = np.where(valid & ~ongrid, pc, TINT_NONE).astype(np.uint8)

    flat_idx = np.where(valid, pc * (S * S) + py * S + px, 0).astype(np.int32)
    plate_out = np.where(valid, pc, -1).astype(np.int32)

    used = (
        (np.arange(MAX_PLATES, dtype=np.int32)[:, None, None] == plate_out[None])
        & valid[None]
    ).any(axis=(1, 2))

    return dict(
        plate=plate_out,
        px=np.where(valid, px, 0).astype(np.int32),
        py=np.where(valid, py, 0).astype(np.int32),
        valid=valid,
        tint=tint,
        flat_idx=flat_idx,
        plates_used=used,
    )


def plate_resolver_mode(globe) -> str:
    """How the float32 torch builder and the posed kernels resolve a ray's
    plate on *globe*: ``"maxdot"`` (the strict first-max of the forward
    dots), ``"fast"`` (the ``fast`` globe's resolver twin) or ``"script"``
    (any other resolver, a ``.lua`` or ``.py`` script's ``globe_plate``:
    :func:`script_plates` evaluates it on the rotated unit rays as
    tensors, and the kernels read the plate it gives each ray).  A globe
    whose resolver does not evaluate on tensors (``jittable`` False) has no
    device path: :func:`build_lensmap` and the Session route it to the
    exact host builder, and this raises for it."""
    from blinky_tpu_torch.globes.builtin import TORCH_RESOLVERS

    if globe.plate_resolver is None:
        return "maxdot"
    if globe.plate_resolver in TORCH_RESOLVERS:
        return "fast"
    if not getattr(globe, "jittable", True):
        raise ValueError(
            f"globe '{globe.name}': its plate resolver does not evaluate on "
            "tensors (jittable is False), so it builds on the exact host path")
    return "script"


def script_plates(globe, x, y, z):
    """A script globe's plates: its resolver on the unit rays ``x, y, z``
    (float32 tensors, as the JAX float32 builder calls it,
    ``blinky_tpu/lensmap/builder.py:228-236``) -> int32 plates of their
    shape on their device, -1 where the script gives none."""
    plate = torch.as_tensor(globe.plate_resolver(x, y, z, globe), device=x.device)
    return torch.broadcast_to(plate, x.shape).to(torch.int32).contiguous()


def plate_dists_f32(globe) -> list:
    """Per-plate pinhole distance as the float32 builder uses it:
    ``0.5 / tan(fov/2)`` in double from the f32-stored fov
    (``fisheye.c:2060``), then rounded to float32."""
    return [float(np.float32(0.5 / math.tan(float(globe.fov_rad[k]) / 2)))
            for k in range(globe.numplates)]


def rubix_grid_consts(platesize, numcells, cell_size, pad_size):
    """(unit size in pixels, block size, pad size) of the rubix grid test,
    all doubles, as the float32 builder computes them: block size and unit
    count from the float32 parameters in float32, the unit size in double
    (the x64 test mesh and the C; see :func:`rubix_grid_mask`)."""
    f32 = np.float32
    nc, cs, ps = f32(numcells), f32(cell_size), f32(pad_size)
    with np.errstate(all="ignore"):
        block = ps + cs
        num_units = nc * block + ps
        unit = np.float64(platesize) / np.float64(num_units)
    return float(unit), float(block), float(ps)


def rubix_grid_lines(platesize, numcells, cell_size, pad_size) -> np.ndarray:
    """[S] bool: whether plate coordinate ``px`` (or ``py``) lies on a rubix
    grid line.  The grid test depends on one integer coordinate at a time,
    so this table, computed in double with :func:`rubix_grid_consts`' values
    as :func:`rays_to_lensmap_torch` computes it per pixel, gives its bits:
    a texel is on the grid where ``lines[px] | lines[py]``."""
    unit, block, pad = rubix_grid_consts(platesize, numcells, cell_size, pad_size)
    with np.errstate(all="ignore"):  # f_rubixgrid 0 0 0: fmod(0, 0) is NaN
        return np.fmod(np.arange(platesize, dtype=np.float64) / unit, block) < pad


def rotate_normalize_torch(vx, vy, vz, view_basis=None):
    """The rays the plate resolve reads: ``vx, vy, vz`` (float32 tensors)
    rotated by *view_basis* (None, or a [..., 3, 3] tensor of (forward,
    right, up) rows, whose leading dims the outputs gain), then normalized,
    each operation rounded on its own in the JAX float32 builder's order:
    the f32 rotation ``rx*right + ry*up + rz*forward``, then ``normalize_c``
    with an f32 sqrt (a zero length leaves the ray, a NaN length is
    truthy).  The plain version of K13 (:func:`rotate_rays`)."""
    f32 = torch.float32
    dev = vx.device
    vx, vy, vz = (t.to(f32) for t in (vx, vy, vz))
    if view_basis is not None:
        vb = view_basis.to(device=dev, dtype=f32)
        lead = tuple(vb.shape[:-2])

        def c(i, j):  # basis row i (0 fwd, 1 right, 2 up), component j
            return vb[..., i, j].reshape(lead + (1,) * vx.dim())

        vx, vy, vz = (
            vx * c(1, 0) + vy * c(2, 0) + vz * c(0, 0),
            vx * c(1, 1) + vy * c(2, 1) + vz * c(0, 1),
            vx * c(1, 2) + vy * c(2, 2) + vz * c(0, 2),
        )

    # normalize_c (mathlib.c:412-429) with the f32 sqrt of the f32 builder
    sumsq = vx * vx + vy * vy + vz * vz
    length = torch.sqrt(sumsq)
    nonzero = length != 0
    one = torch.ones_like(length)
    inv = torch.where(nonzero, one / torch.where(nonzero, length, one), one)
    return vx * inv, vy * inv, vz * inv


def rotate_rays(vx, vy, vz, bases=None):
    """K13, the rotate pre-pass of a script globe: the unit rays the
    kernels resolve, for the script's resolver to evaluate on.

    With ``bases`` (a contiguous float32 [B, 3, 3] tensor), ``vx, vy, vz``
    are one contiguous float32 table (any shape) and the outputs gain a
    leading pose axis: the rays rotated by each basis and normalized, the
    arithmetic of ``resolve.cuh``'s ``rotate_normalize``, which K6 and K8
    run.  With ``bases`` None the table's leading axis is the batch (a zoom
    step's rays) and the rays are normalized only, as K9 takes them.
    Launches ``blinky_rotate_rays`` (``csrc/lensmap.cu``) for tensors on a
    card and runs the plain version, :func:`rotate_normalize_torch`, for
    tensors on the CPU."""
    name = "rotate_rays"
    dev = vx.device
    shape = tuple(vx.shape)
    for what, t in (("vx", vx), ("vy", vy), ("vz", vz)):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name}: {what} must be a contiguous float32 tensor of shape "
                             f"{shape} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if bases is not None and (bases.dtype != torch.float32 or bases.dim() != 3
                              or tuple(bases.shape[1:]) != (3, 3)
                              or not bases.is_contiguous() or bases.device != dev):
        raise ValueError(f"{name}: bases must be a contiguous float32 [B, 3, 3] tensor on "
                         f"{dev}, got {bases.dtype} {tuple(bases.shape)} on {bases.device}")
    if bases is None and not shape:
        raise ValueError(f"{name}: without bases the rays need a leading batch axis")
    if not _build.on_card(name, dev):
        return rotate_normalize_torch(vx, vy, vz, bases)
    batch = int(bases.shape[0]) if bases is not None else shape[0]
    out_shape = (batch,) + shape if bases is not None else shape
    npix = vx.numel() if bases is not None else vx.numel() // max(batch, 1)
    with _build.on_device(dev) as stream:
        out = [torch.empty(out_shape, dtype=torch.float32, device=dev) for _ in range(3)]
        if out[0].numel():
            _build.launch(rotate_rays, name, "blinky_rotate_rays",
                vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), npix, _build.ptr(bases), batch,
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream)
    return tuple(out)


rotate_rays.launches = 0


def rays_to_lensmap_torch(globe, vx, vy, vz, lens_valid, platesize,
                          numcells, cell_size, pad_size, view_basis=None,
                          plate=None):
    """:func:`rays_to_lensmap` in float32 on torch tensors of any device:
    the lens-independent half of the JAX package's float32 builder
    (``blinky_tpu.lensmap.builder.rays_to_lensmap`` with ``dtype`` f32).

    ``vx, vy, vz`` f32 and ``lens_valid`` bool, [H, W]; ``view_basis`` None
    or a [..., 3, 3] tensor of (forward, right, up) rows, whose leading
    dims the outputs gain.  Each operation rounds on its own, in the JAX
    code's order: :func:`rotate_normalize_torch`; f32 ``DotProduct``s; the
    strict-``>`` first-max plate (NaN keeps plate 0), the ``fast``
    resolver's twin or a script's plates (*plate*, an integer tensor of
    the outputs' shape, or, when None, :func:`script_plates` of the unit
    rays), valid where >= 0 and clipped to the globe's plates; f32
    ``safe_div``, ``* dist``, ``+ 0.5``; truncation of ``u * S``; the
    rubix grid test in double (:func:`rubix_grid_consts`).  No ``addcmul``
    or other fused multiply-add: the CUDA kernels, which this is the plain
    version of, round the same way.  Returns the fields of
    :func:`rays_to_lensmap` as tensors.
    """
    S = platesize
    dev = vx.device
    vx, vy, vz = rotate_normalize_torch(vx, vy, vz, view_basis)

    n = globe.numplates
    frames = [np.asarray(a, np.float32) for a in (globe.forward, globe.right, globe.up)]

    def dot3(vecs, k):  # f32 DotProduct with plate k's stored vec_t frame
        return (vx * float(vecs[k, 0]) + vy * float(vecs[k, 1])
                + vz * float(vecs[k, 2]))

    dF = [dot3(frames[0], k) for k in range(n)]
    mode = plate_resolver_mode(globe)
    if mode == "fast":
        from blinky_tpu_torch.globes.builtin import TORCH_RESOLVERS

        plate = TORCH_RESOLVERS[globe.plate_resolver](vx, vy, vz)
        pc = plate.clamp(0, n - 1)
    elif mode == "script":
        if plate is None:
            plate = script_plates(globe, vx, vy, vz)
        plate = torch.broadcast_to(plate.to(device=dev, dtype=torch.int32), vx.shape)
        pc = plate.clamp(0, n - 1)
    else:
        best = dF[0]
        pc = torch.zeros(best.shape, dtype=torch.int32, device=dev)
        for k in range(1, n):
            m_k = dF[k] > best  # strict >: first maximum wins; NaN keeps 0
            best = torch.where(m_k, dF[k], best)
            pc = torch.where(m_k, k, pc)
        plate = pc

    # frame dots of the selected plate (ray_to_plate_uv, fisheye.c:2052-2058)
    rz, rx, ry = dF[0], dot3(frames[1], 0), dot3(frames[2], 0)
    dists = plate_dists_f32(globe)
    dist = torch.full_like(rz, dists[0])
    for k in range(1, n):
        sel = pc == k
        rz = torch.where(sel, dF[k], rz)
        rx = torch.where(sel, dot3(frames[1], k), rx)
        ry = torch.where(sel, dot3(frames[2], k), ry)
        dist = torch.where(sel, dists[k], dist)

    zero = rz == 0
    den = torch.where(zero, 1.0, rz)
    u = torch.where(zero, 0.0, rx / den) * dist + 0.5
    v = torch.where(zero, 0.0, -ry / den) * dist + 0.5
    uv_valid = ~zero & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    u = torch.where(uv_valid, u, 0.0)
    v = torch.where(uv_valid, v, 0.0)
    px = (u * S).to(torch.int32)  # C truncation cast, fisheye.c:1988
    py = (v * S).to(torch.int32)
    in_bounds = (px >= 0) & (px < S) & (py >= 0) & (py < S)  # fisheye.c:1971
    valid = lens_valid.to(dev) & (plate >= 0) & uv_valid & in_bounds

    # the rubix grid test (set_lensmap_grid, fisheye.c:1922-1960) in double;
    # the unit size is a device tensor, so no backend turns the division
    # into a multiply by its reciprocal
    unit, block, pad = rubix_grid_consts(S, numcells, cell_size, pad_size)
    unit = torch.tensor(unit, dtype=torch.float64, device=dev)
    ongrid = ((torch.fmod(px.to(torch.float64) / unit, block) < pad)
              | (torch.fmod(py.to(torch.float64) / unit, block) < pad))
    tint = torch.where(valid & ~ongrid, pc, TINT_NONE).to(torch.uint8)

    flat_idx = torch.where(valid, pc * (S * S) + py * S + px, 0).to(torch.int32)
    plate_out = torch.where(valid, pc, -1).to(torch.int32)
    used = torch.stack([((plate_out == p) & valid).flatten(-2).any(-1)
                        for p in range(MAX_PLATES)], dim=-1)
    return dict(
        plate=plate_out,
        px=torch.where(valid, px, 0).to(torch.int32),
        py=torch.where(valid, py, 0).to(torch.int32),
        valid=valid,
        tint=tint,
        flat_idx=flat_idx,
        plates_used=used,
    )


# the plate constants the resolve kernels take by value: per plate forward,
# right, up, dist
PLATE_FLOATS = 10
RESOLVERS = {"maxdot": 0, "fast": 1, "script": 2}


def plate_consts(globe) -> np.ndarray:
    """The globe's plates as the resolve kernels take them; the slots past
    ``numplates`` repeat plate 0, whose forward dot never beats the maximum
    so far, so the max-dot select needs no plate count."""
    out = np.zeros((MAX_PLATES, PLATE_FLOATS), np.float32)
    n = globe.numplates
    out[:n, 0:3] = np.asarray(globe.forward, np.float32)
    out[:n, 3:6] = np.asarray(globe.right, np.float32)
    out[:n, 6:9] = np.asarray(globe.up, np.float32)
    out[:n, 9] = plate_dists_f32(globe)
    out[n:] = out[0]
    return out.reshape(-1)


# K6's fourth plate resolver (csrc/resolve.cuh, kCube): the max-dot select
# on a cube, taken from the ray's signed components.  Only K6's entry point
# takes it; K8 and K9 resolve a cube by max-dot.
CUBE_RESOLVER = 3


@functools.lru_cache(maxsize=16)
def cube_resolver(globe) -> bool:
    """Whether K6 resolves *globe* by :data:`CUBE_RESOLVER`: a max-dot
    globe whose six plates face the six signed axes, with every forward,
    right and up vector a signed axis (one nonzero entry, +-1 in float32):
    ``cube``, or a cube with its plates relabelled or turned by right
    angles.  Each forward dot is then a signed component of the unit ray,
    and the kernel picks the plate from the components, bit-equal to
    max-dot.  An axis-aligned globe that misses a signed axis keeps
    max-dot: there the largest dot need not be the largest magnitude.  Made
    once a globe."""
    if globe.plate_resolver is not None or globe.numplates != MAX_PLATES:
        return False
    facing = None
    for vecs in (globe.forward, globe.right, globe.up):
        vecs = np.asarray(vecs, np.float32)
        nonzero = vecs != 0
        if not (nonzero.sum(1) == 1).all() or not (np.abs(vecs[nonzero]) == 1).all():
            return False
        if facing is None:  # 2 * axis + 1 where the forward vector points down it
            facing = 2 * nonzero.argmax(1) + (vecs[nonzero] < 0)
    return len(set(facing.tolist())) == MAX_PLATES


@functools.lru_cache(maxsize=16)
def grid_line_words(platesize, numcells, cell_size, pad_size, device):
    """:func:`rubix_grid_lines` as the resolve kernels read it: an int32
    tensor on *device*, bit ``px % 32`` of word ``px // 32``; made and
    uploaded once a grid."""
    lines = rubix_grid_lines(platesize, numcells, cell_size, pad_size)
    bits = np.packbits(np.pad(lines, (0, -platesize % 32)), bitorder="little")
    return torch.from_numpy(bits.view("<i4").copy()).to(device)


def resolver_args(globe):
    """(plates, numplates, resolver, fast_dist, fast_half): the globe as the
    resolve kernels' C interface takes it; ``plates`` is a host array whose
    pointer the caller keeps alive over the launch."""
    from blinky_tpu_torch.globes.builtin import fast_resolver_consts

    fast_dist, fast_half = (float(np.float32(c)) for c in fast_resolver_consts())
    return (plate_consts(globe), globe.numplates,
            RESOLVERS[plate_resolver_mode(globe)], fast_dist, fast_half)


def basis_f32(view_basis) -> np.ndarray:
    """A (forward, right, up) basis, a [3, 3] array, tensor or triple of
    3-vectors, as a host float32 [3, 3] array."""
    if isinstance(view_basis, torch.Tensor):
        b = view_basis.detach().to("cpu", torch.float32).numpy()
    else:
        b = np.asarray([np.asarray(v, np.float64) for v in view_basis]).astype(np.float32)
    if b.shape != (3, 3):
        raise ValueError(f"view_basis must be (forward, right, up) 3-vectors, got {b.shape}")
    return np.ascontiguousarray(b)


def lensmap_resolve(globe, vx, vy, vz, lens_valid, platesize, numcells,
                    cell_size, pad_size, view_basis, plate=None):
    """K8, the float32 builder's resolve: the lens stage's rays, rotated by
    *view_basis*, -> the lensmap's tables, as :func:`rays_to_lensmap_torch`
    gives them, bit for bit.

    ``vx, vy, vz`` contiguous f32 and ``lens_valid`` contiguous bool, all
    [H, W] on one device; ``view_basis`` (forward, right, up), always
    applied: a build without a view passes the identity, as the JAX
    builder does.  A script globe resolves in mode 2: *plate*, a
    contiguous int32 [H, W] tensor, or when None the script's plates of
    the rays that :func:`rotate_rays` (K13) rotates (:func:`script_plates`).
    Launches ``blinky_lensmap_resolve`` (``csrc/lensmap.cu``) for tensors on
    a card and runs the plain version for tensors on the CPU.
    """
    name = "lensmap_resolve"
    dev = vx.device
    shape = tuple(vx.shape)
    for what, t, dtype in (("vx", vx, torch.float32), ("vy", vy, torch.float32),
                           ("vz", vz, torch.float32), ("lens_valid", lens_valid, torch.bool)):
        if (t.dtype != dtype or tuple(t.shape) != shape or len(shape) != 2
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(
                f"{name}: {what} must be a contiguous {dtype} [H, W] tensor on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    S = int(platesize)
    basis = basis_f32(view_basis)
    globe_args = resolver_args(globe)  # a non-jittable globe raises here
    if globe_args[2] == RESOLVERS["script"]:
        if plate is None:
            plate = script_plates(globe, *rotate_rays(
                vx, vy, vz, torch.from_numpy(basis)[None].to(dev)))[0]
        if (plate.dtype != torch.int32 or tuple(plate.shape) != shape
                or not plate.is_contiguous() or plate.device != dev):
            raise ValueError(f"{name}: plate must be a contiguous int32 {shape} tensor on "
                             f"{dev}, got {plate.dtype} {tuple(plate.shape)} on {plate.device}")
    else:
        plate = None
    if not _build.on_card(name, dev):
        return rays_to_lensmap_torch(globe, vx, vy, vz, lens_valid, S, numcells,
                                     cell_size, pad_size,
                                     view_basis=torch.from_numpy(basis), plate=plate)
    with _build.on_device(dev) as stream:
        out = {f: torch.empty(shape, dtype=dt, device=dev) for f, dt in (
            ("plate", torch.int32), ("px", torch.int32), ("py", torch.int32),
            ("valid", torch.bool), ("tint", torch.uint8), ("flat_idx", torch.int32))}
        used = torch.zeros(MAX_PLATES, dtype=torch.int32, device=dev)
        if vx.numel():
            plates, nplates, resolver, fast_dist, fast_half = globe_args
            lines = grid_line_words(S, float(numcells), float(cell_size), float(pad_size), dev)
            _build.launch(lensmap_resolve, name, "blinky_lensmap_resolve",
                vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), lens_valid.data_ptr(),
                vx.numel(), basis.ctypes.data, plates.ctypes.data, nplates, resolver,
                fast_dist, fast_half, _build.ptr(plate), lines.data_ptr(), S,
                out["plate"].data_ptr(),
                out["px"].data_ptr(), out["py"].data_ptr(), out["valid"].data_ptr(),
                out["tint"].data_ptr(), out["flat_idx"].data_ptr(), used.data_ptr(), stream)
            lensmap_resolve.given_launches += resolver == RESOLVERS["script"]
        out["plates_used"] = used != 0
    return out


lensmap_resolve.launches = 0
lensmap_resolve.given_launches = 0  # the launches in resolver mode 2 (a script globe)


def inverse_grid(lens, globe, scale, width_px, height_px, platesize,
                 numcells, cell_size, pad_size, view_basis=None, row_range=None):
    """The full inverse-path lensmap computation over the pixel grid:
    :func:`lens_ray_grid` (lens math) then :func:`rays_to_lensmap`.  The
    lens math deliberately rides IEEE nan/inf (the Lua VM's C operators
    never trap — ``fisheye.c`` masks invalid pixels afterwards), so
    NumPy's RuntimeWarnings are suppressed for the duration.

    ``row_range=(r0, r1)`` computes only screen rows ``r0..r1`` (the
    resumable build's cursor, ``fisheye.c:306-322``): every per-pixel
    quantity is elementwise in the pixel's absolute coordinates, so a row
    block is bit-identical to the same rows of a full build, and its
    ``plates_used`` covers just the block."""
    with np.errstate(all="ignore"):
        vx, vy, vz, lens_valid = lens_ray_grid(lens, scale, width_px, height_px,
                                               row_range=row_range)
        return rays_to_lensmap(
            globe, vx, vy, vz, lens_valid, platesize,
            numcells, cell_size, pad_size, view_basis=view_basis)


# the (lens, globe, shape, device) keys whose float32 builder has run in this
# process (bounded: the oldest key goes first)
_WARM_BUILDERS: dict = {}

IDENTITY_BASIS = ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def _warm_key(lens, globe, width_px, height_px, platesize, device):
    return (lens, globe, int(width_px), int(height_px), int(platesize),
            str(torch.device(device)))


def device_builder_warm(lens, globe, width_px, height_px, platesize=None,
                        device="cuda") -> bool:
    """True once the float32 builder for this (lens, globe, shape) has run
    on *device* in this process: the kernels are built and loaded and the
    device's allocator holds the build's blocks, so a rebuild costs
    milliseconds.  (The JAX package answers the same question about its
    jit's first compile.)"""
    if platesize is None:
        platesize = min(width_px, height_px)
    return _warm_key(lens, globe, width_px, height_px, platesize, device) in _WARM_BUILDERS


@spanned("build.lensmap")
def build_lensmap(
    lens: LensDef,
    globe: Globe,
    scale: float,
    width_px: int,
    height_px: int,
    platesize: Optional[int] = None,
    numcells: int = 10,
    cell_size: float = 4.0,
    pad_size: float = 1.0,
    backend: str = "numpy",
    view_basis=None,
    device="cuda",
) -> LensMap:
    """Build the lensmap of *lens*.

    ``backend``: ``"numpy"`` (the default), the exact float64 host path,
    NumPy arrays; or ``"torch"``, the float32 builder on *device* (``"cuda"``
    unless the caller asks for another): the lens stage as tensor
    operations, then :func:`lensmap_resolve` (K8 on a card).  Its tables are
    tensors on the device; :meth:`LensMap.to_numpy` copies them out.  A
    forward-mapped lens rasterizes on the host under either backend
    (:func:`blinky_tpu_torch.lensmap.forward_raster.build_forward`) and
    returns NumPy tables, and so does a lens or globe that does not
    evaluate on tensors (``jittable`` False, a ``.lua`` script that needs
    per-lane control) on the exact host path.

    ``platesize`` defaults to ``min(width_px, height_px)``
    (``fisheye.c:707``).  ``view_basis``: optional (forward, right, up)
    camera basis rotating the view within recorded plates; the float32
    builder rotates by the identity when there is none, as the JAX builder
    does.
    """
    if backend not in ("numpy", "torch"):
        raise ValueError(f"unknown lensmap backend {backend!r}")
    if platesize is None:
        platesize = min(width_px, height_px)
    if not (getattr(lens, "jittable", True) and getattr(globe, "jittable", True)):
        # a .lua lens or globe whose map or resolver does not evaluate on
        # tensors (decided at load, lua_bridge) builds on the exact host
        # path, by the JAX package's rule (blinky_tpu/lensmap/builder.py:412)
        backend = "numpy"
    if lens.map_type == "forward":
        # a serial scatter with no float32 twin: the host rasterizer, NumPy
        # tables, whatever the backend
        from blinky_tpu_torch.lensmap.forward_raster import build_forward

        return build_forward(
            lens, globe, scale, width_px, height_px, platesize,
            numcells, cell_size, pad_size, view_basis=view_basis,
        )
    if backend == "numpy":
        out = inverse_grid(
            lens, globe, np.float64(scale), width_px, height_px, platesize,
            numcells, cell_size, pad_size,
            view_basis=None if view_basis is None else tuple(
                np.asarray(v, dtype=np.float64) for v in view_basis),
        )
    else:
        rays = lens_rays_torch(lens, scale, width_px, height_px, torch.device(device))
        out = lensmap_resolve(
            globe, *rays, platesize, numcells, cell_size, pad_size,
            IDENTITY_BASIS if view_basis is None else view_basis)
        key = _warm_key(lens, globe, width_px, height_px, platesize, device)
        _WARM_BUILDERS[key] = True
        while len(_WARM_BUILDERS) > 64:
            _WARM_BUILDERS.pop(next(iter(_WARM_BUILDERS)))
    return LensMap(
        width_px=width_px,
        height_px=height_px,
        platesize=platesize,
        numplates=globe.numplates,
        scale=float(scale),
        **out,
    )
