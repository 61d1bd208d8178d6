"""Static-ray pose recomposition: pose playback with no lens math per pose.

The port of :mod:`blinky_tpu.kernels.static_ray`.  In the reference a view
rotation never touches the lensmap: the pose enters through the plate
render basis (``F_RenderView``, ``engine/NQ/fisheye.c:750,2427-2450``),
while the lensmap depends only on (lens, globe, zoom, size)
(``fisheye.c:2346-2397``).  So:

1. Once per (lens, zoom scale, size), build a per-pixel **ray table**: the
   pre-rotation camera-frame rays of the inverse build, from the float32
   lens stage on the device or from the float64 one on the host, truncated
   to float32 (:func:`ray_table_from_lens`), or texel-center rays rebuilt
   from a lensmap (:func:`ray_table_from_lensmap`).
2. Per pose, rotate the rays, resolve each to a plate and a texel
   (:func:`blinky_tpu_torch.lensmap.builder.rays_to_lensmap_torch`, in
   float32) and gather one texel per pixel from that pose's own frame.

On a card step 2 is one hand-written CUDA kernel, K6
(``blinky_static_ray_posed`` in ``csrc/posed.cu``): the index math and the
gather fused, so the per-pose index table is never written.
:func:`static_ray_posed` launches it for tensors on a card and runs its
plain version, :func:`static_ray_posed_plain`, for tensors on the CPU.

A script globe's resolver runs per pose on the rotated rays, as in the JAX
package (``blinky_tpu/kernels/static_ray.py:235-244``):
:func:`script_pose_plates` rotates the table by each pose (K13, the
pre-pass that runs K6's own rotation) and evaluates the script on those
rays as tensors, and K6 reads the int8 plate it gave each pose-pixel
(resolver mode 2).

As in the JAX package, :func:`build_ray_table` evaluates a traceable
inverse lens in float32 on the device, which keeps the table bit-aligned
with the fused posed pipeline
(:class:`blinky_tpu_torch.kernels.posed.PosedRemapKernel`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blinky_tpu_torch.budget import feasible_batch, script_bytes_per_lane
from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.kernels.posed import (
    check_gather_operands, check_render_scale, gather_posed_plain,
    prep_posed_inputs,
)
from blinky_tpu_torch.lensmap.builder import (
    CUBE_RESOLVER, RESOLVERS, TINT_NONE, LensMap, cube_resolver, grid_line_words,
    lens_ray_grid, lens_rays_torch, plate_resolver_mode, rays_to_lensmap_torch,
    resolver_args, rotate_rays, script_plates,
)
from blinky_tpu_torch.palette import MAX_PLATES
from blinky_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True, eq=False)
class RayTable:
    """Per-pixel pre-rotation camera-frame rays for one (lens, zoom, size).

    Components are stored **unnormalized** in float32, as three [H, W]
    planes (NumPy arrays on the host, tensors after :meth:`device`), with
    the bool [H, W] ``lens_valid`` mask.  A table built by the JAX package
    (``blinky_tpu.kernels.static_ray.RayTable``) carries over by handing
    its arrays, as NumPy arrays, to this constructor.
    """

    width_px: int
    height_px: int
    vx: object  # f32 [H, W]
    vy: object
    vz: object
    lens_valid: object  # bool [H, W]
    source: str = "lens"  # "lens" (exact rays) | "lensmap" (texel centers)

    def device(self, device="cuda") -> "RayTable":
        """The same table with its planes as contiguous tensors on
        *device* (uploaded once; a table already there is returned as it
        is)."""
        dev = torch.device(device)

        def up(a, dtype):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a))
            return t.to(device=dev, dtype=dtype).contiguous()

        planes = {f: up(getattr(self, f), dt) for f, dt in (
            ("vx", torch.float32), ("vy", torch.float32), ("vz", torch.float32),
            ("lens_valid", torch.bool))}
        if all(t is getattr(self, f) for f, t in planes.items()):
            return self
        return dataclasses.replace(self, **planes)


def ray_table_from_lens(lens, scale, width_px, height_px,
                        backend="numpy", device="cuda") -> RayTable:
    """Ray table for an inverse-capable lens: run the lens stage once.

    ``backend="torch"`` evaluates ``lens.inverse`` in float32 on *device*
    (:func:`blinky_tpu_torch.lensmap.builder.lens_rays_torch`), and the
    table's planes are those tensors: the counterpart of the JAX package's
    jitted lens stage, bit-aligned with the fused posed pipeline.
    ``backend="numpy"`` (scalar-only lenses, or parity checks) evaluates the
    lens math in float64 on the host and truncates the rays to float32 at
    the table boundary; the per-pose rotation then runs in float32 either
    way.
    """
    if getattr(lens, "map_type", "inverse") != "inverse":
        raise ValueError(
            f"lens '{getattr(lens, 'name', lens)}' has no inverse map — "
            "build its table from a forward-rasterized lensmap "
            "(ray_table_from_lensmap)")
    if backend == "torch":
        vx, vy, vz, lens_valid = lens_rays_torch(
            lens, scale, int(width_px), int(height_px), torch.device(device))
        return RayTable(int(width_px), int(height_px), vx, vy, vz, lens_valid,
                        source="lens")
    if backend != "numpy":
        raise ValueError(f"unknown ray-table backend {backend!r}")
    with np.errstate(all="ignore"):
        vx, vy, vz, lens_valid = lens_ray_grid(
            lens, np.float64(scale), width_px, height_px)
    shape = (height_px, width_px)
    return RayTable(
        int(width_px), int(height_px),
        np.broadcast_to(np.asarray(vx), shape).astype(np.float32),
        np.broadcast_to(np.asarray(vy), shape).astype(np.float32),
        np.broadcast_to(np.asarray(vz), shape).astype(np.float32),
        np.asarray(lens_valid),
        source="lens",
    )


def ray_table_from_lensmap(lm: LensMap, globe) -> RayTable:
    """Ray table reconstructed from a BUILT lensmap (the route of the
    forward-only lenses): each valid pixel's stored (plate, px, py)
    becomes its texel CENTER ray via ``plate_uv_to_ray``
    (``fisheye.c:1198-1214``) with the C types, u/v recentered in double
    and truncated to f32, then the f32 ``VectorMA`` chain
    ``dist*fwd + u*right + v*up``, left unnormalized.  Pure NumPy."""
    plate = np.asarray(lm.plate)
    px = np.asarray(lm.px)
    py = np.asarray(lm.py)
    valid = np.asarray(lm.valid)
    S = lm.platesize
    u32 = (((px.astype(np.float64) + 0.5) / S) - 0.5).astype(np.float32)
    v32 = (-(((py.astype(np.float64) + 0.5) / S) - 0.5)).astype(np.float32)
    fwd = np.asarray(globe.forward, np.float32)
    rgt = np.asarray(globe.right, np.float32)
    up = np.asarray(globe.up, np.float32)
    dist = np.asarray(globe.dist, np.float32)
    rx = np.zeros(plate.shape, np.float32)
    ry = np.zeros(plate.shape, np.float32)
    rz = np.zeros(plate.shape, np.float32)
    for k in range(globe.numplates):
        sel = valid & (plate == k)
        # VectorMA order (mathlib.c:349-355): dist*fwd, then += u*right,
        # then += v*up, all f32, left to right
        rx = np.where(sel, dist[k] * fwd[k, 0] + u32 * rgt[k, 0] + v32 * up[k, 0], rx)
        ry = np.where(sel, dist[k] * fwd[k, 1] + u32 * rgt[k, 1] + v32 * up[k, 1], ry)
        rz = np.where(sel, dist[k] * fwd[k, 2] + u32 * rgt[k, 2] + v32 * up[k, 2], rz)
    return RayTable(lm.width_px, lm.height_px, rx, ry, rz, valid,
                    source="lensmap")


def build_ray_table(lens, globe, scale, width_px, height_px,
                    platesize=None, lensmap=None, device="cuda") -> RayTable:
    """Route a lens to its ray-table source, as the JAX package does:

    * an inverse lens that evaluates on tensors, on a globe that does
      (``jittable``) -> the float32 lens stage on *device* (bit-aligned
      with the fused posed pipeline);
    * any other inverse lens (a ``.lua`` script that needs per-lane
      control) -> the float64 host lens stage, its rays truncated to
      float32 (``ray_table_from_lens(backend="numpy")``);
    * a forward-only lens -> the texel centers of the host forward
      rasterization (*lensmap* when its size and zoom scale match, else a
      new :func:`blinky_tpu_torch.lensmap.forward_raster.build_forward`;
      rubix tint is recomputed per pose, so the tint in it is irrelevant).
    """
    if platesize is None:
        platesize = min(width_px, height_px)
    if getattr(lens, "map_type", "inverse") == "inverse":
        on_tensors = getattr(lens, "jittable", True) and getattr(globe, "jittable", True)
        return ray_table_from_lens(lens, scale, width_px, height_px,
                                   backend="torch" if on_tensors else "numpy",
                                   device=device)
    if lensmap is None or lensmap.width_px != width_px \
            or lensmap.height_px != height_px \
            or lensmap.platesize != platesize \
            or lensmap.scale != float(scale):
        from blinky_tpu_torch.lensmap.forward_raster import build_forward

        lensmap = build_forward(lens, globe, float(scale), int(width_px),
                                int(height_px), int(platesize))
    return ray_table_from_lensmap(lensmap, globe)


def _check_table(kernel, table, device):
    hb, wb = table.height_px, table.width_px
    for name, dtype in (("vx", torch.float32), ("vy", torch.float32),
                        ("vz", torch.float32), ("lens_valid", torch.bool)):
        t = getattr(table, name)
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                or tuple(t.shape) != (hb, wb) or not t.is_contiguous()
                or t.device != device):
            raise ValueError(
                f"{kernel}: ray table {name} must be a contiguous {dtype} "
                f"tensor of shape {(hb, wb)} on {device} (RayTable.device)")


def script_piece(table) -> int:
    """The poses one piece of :func:`script_pose_plates` may take on
    *table*: as many as fit the free memory of its device now
    (:func:`blinky_tpu_torch.budget.script_bytes_per_lane`)."""
    return feasible_batch(script_bytes_per_lane(table.vx.numel()), 0, device=table.vx.device)


def script_pose_plates(table, bases, globe, piece=None):
    """A script globe's plates for every pose: per pose, the table's rays
    rotated and normalized by :func:`rotate_rays` (K13 on a card) and the
    script's resolver on them as tensors (:func:`script_plates`), clamped
    to [-1, MAX_PLATES] (which keeps ``plate >= 0`` and the clip to the
    globe's plates) -> int8 [B, H, W] on the table's device.  The poses go
    in pieces of *piece* poses, by default :func:`script_piece` read now.
    The stage is the span ``posed.script_plates``, each piece (its K13
    launch and its evaluation) a ``posed.script_piece``, counted by
    ``script_pose_plates.pieces``."""
    dev = table.vx.device
    B = int(bases.shape[0])
    with span("posed.script_plates"):
        out = torch.empty((B,) + tuple(table.vx.shape), dtype=torch.int8, device=dev)
        chunk = script_piece(table) if piece is None else int(piece)
        for lo in range(0, B, chunk):
            with span("posed.script_piece"):
                rays = rotate_rays(table.vx, table.vy, table.vz, bases[lo:lo + chunk])
                out[lo:lo + chunk] = script_plates(globe, *rays).clamp(-1, MAX_PLATES)
                del rays
            script_pose_plates.pieces += 1
    return out


script_pose_plates.pieces = 0  # the pieces evaluated: one K13 launch and one evaluation each


def static_ray_posed_plain(src, table, bases, globe, platesize, numcells,
                           cell_size, pad_size, expanded, background, k,
                           plates=None):
    """K6's plain version: per pose, :func:`rays_to_lensmap_torch` of the
    rotated table (a script globe's *plates* given, [B, H, W]), the
    expanded source's tinted-half offset (``expanded_flat_idx``,
    ``fisheye.c:2416-2419``), then :func:`gather_posed_plain` ->
    [B, H, W]."""
    S = platesize
    lm = rays_to_lensmap_torch(globe, table.vx, table.vy, table.vz,
                               table.lens_valid, S, numcells, cell_size,
                               pad_size, view_basis=bases, plate=plates)
    idx, valid = lm["flat_idx"], lm["valid"]
    if expanded:
        idx = idx + torch.where((lm["tint"] != TINT_NONE) & valid,
                                MAX_PLATES * S * S, 0).to(torch.int32)
    return gather_posed_plain(src, idx, valid, background, k)


def static_ray_posed(src, table, bases, globe, platesize, numcells,
                     cell_size, pad_size, expanded, background, k, plates=None):
    """K6, E with D fused: per pose, rotate the ray table by ``bases[b]``,
    resolve plate and texel as :func:`rays_to_lensmap_torch` does, and
    gather from pose ``b``'s frame -> [B, H, W].

    ``src`` [B, N] u8 or int32 bits, pose-major (:func:`prep_posed_inputs`),
    N = 6·S² or 12·S² when *expanded*; ``table`` a :class:`RayTable` on the
    device, [H/k, W/k]; ``bases`` [B, 3, 3] f32; ``background`` [H, W] of
    src's dtype; ``k`` the render scale.  A script globe resolves in mode
    2 from *plates*, a contiguous int8 [B, H/k, W/k] tensor, by default
    :func:`script_pose_plates`; a cube (:func:`cube_resolver`) in mode 3,
    the max-dot select taken from the ray's signed components.
    """
    name = "static_ray_posed"
    check_gather_operands(name, src, table.height_px, table.width_px, background, k)
    dev = src.device
    _check_table(name, table, dev)
    B, N = src.shape
    S = int(platesize)
    if N != (2 if expanded else 1) * MAX_PLATES * S * S:
        raise ValueError(f"{name}: src has {N} texels a pose; platesize {S} "
                         f"{'expanded ' if expanded else ''}needs "
                         f"{(2 if expanded else 1) * MAX_PLATES * S * S}")
    if (bases.dtype != torch.float32 or tuple(bases.shape) != (B, 3, 3)
            or not bases.is_contiguous() or bases.device != dev):
        raise ValueError(f"{name}: bases must be a contiguous float32 [B={B}, 3, 3] "
                         f"tensor on {dev}, got {bases.dtype} {tuple(bases.shape)}")
    globe_args = resolver_args(globe)  # a non-jittable globe raises here
    hb, wb = table.height_px, table.width_px
    if globe_args[2] == RESOLVERS["script"]:
        if plates is None:
            plates = script_pose_plates(table, bases, globe)
        if (plates.dtype != torch.int8 or tuple(plates.shape) != (B, hb, wb)
                or not plates.is_contiguous() or plates.device != dev):
            raise ValueError(f"{name}: plates must be a contiguous int8 [{B}, {hb}, {wb}] "
                             f"tensor on {dev}, got {plates.dtype} {tuple(plates.shape)}")
    else:
        plates = None
    if not _build.on_card(name, dev):
        return static_ray_posed_plain(src, table, bases, globe, S, numcells,
                                      cell_size, pad_size, expanded, background, k,
                                      plates)
    with _build.on_device(dev) as stream:
        out = torch.empty((B, hb * k, wb * k), dtype=src.dtype, device=dev)
        if out.numel():
            consts, nplates, resolver, fast_dist, fast_half = globe_args
            if resolver == RESOLVERS["maxdot"] and cube_resolver(globe):
                resolver = CUBE_RESOLVER
            lines = (grid_line_words(S, float(numcells), float(cell_size), float(pad_size),
                                     dev) if expanded else None)
            _build.launch(static_ray_posed, name, "blinky_static_ray_posed",
                table.vx.data_ptr(), table.vy.data_ptr(), table.vz.data_ptr(),
                table.lens_valid.data_ptr(), hb, wb, bases.data_ptr(), B,
                consts.ctypes.data, nplates, resolver, fast_dist, fast_half, _build.ptr(plates),
                _build.ptr(lines), S, int(expanded),
                src.data_ptr(), N, src.element_size(), background.data_ptr(),
                int(k), out.data_ptr(), stream)
            static_ray_posed.given_launches += resolver == RESOLVERS["script"]
            static_ray_posed.cube_launches += resolver == CUBE_RESOLVER
    return out


static_ray_posed.launches = 0
static_ray_posed.given_launches = 0  # the launches in resolver mode 2 (a script globe)
static_ray_posed.cube_launches = 0  # the launches in resolver mode 3 (a cube)


def background_tensor(background, height_px, width_px, device):
    """A NumPy [H, W] background (u8, or u32 packed RGBA) -> its tensor on
    *device*: u8, or the RGBA words as int32 bits."""
    if background is None:
        background = np.zeros((height_px, width_px), np.uint8)
    background = np.asarray(background)
    if background.size != height_px * width_px:
        raise ValueError(
            f"background must be [{height_px}, {width_px}], "
            f"got {background.shape}")
    background = background.reshape(height_px, width_px)
    a = (background.view(np.int32) if background.dtype == np.uint32
         else background.astype(np.uint8, copy=False))
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class StaticRayPosedKernel:
    """Per-frame-pose playback through a static ray table.

    Usage::

        k = StaticRayPosedKernel(lens, globe, W, H, scale, device="cuda")
        out = k(frames, bases)   # [P, S, S, B] + [B, 3, 3] -> [B, H, W]

    ``frames``: plain u8 plates, the expanded [12, ...] rubix layout, or
    either as packed RGBA u32 (NumPy ``uint32`` or ``torch.uint32``).
    Construction builds (or takes, as ``ray_table``) the table at the build
    grid, 1/``render_scale`` of the screen, and uploads it to *device*
    once.  Calls return tensors on *device*, ``torch.uint32`` for RGBA.
    """

    def __init__(self, lens, globe, width_px, height_px, scale,
                 platesize=None, numcells=10, cell_size=4.0, pad_size=1.0,
                 background=None, render_scale=1, ray_table=None,
                 lensmap=None, *, device="cuda"):
        plate_resolver_mode(globe)  # a non-jittable globe raises here
        self.device = torch.device(device)
        self.lens = lens
        self.globe = globe
        self.width_px = int(width_px)
        self.height_px = int(height_px)
        self.render_scale = int(render_scale)
        check_render_scale(self.width_px, self.height_px, self.render_scale)
        self.platesize = int(platesize) if platesize else min(width_px, height_px)
        self.scale = float(scale)
        self.numcells = float(numcells)
        self.cell_size = float(cell_size)
        self.pad_size = float(pad_size)
        k = self.render_scale
        W, H = self.width_px // k, self.height_px // k
        if ray_table is None:
            # the table is built at the BUILD grid size with the k-scaled
            # zoom (the every-k-th-ray identity, kernels/posed.py)
            ray_table = build_ray_table(lens, globe, self.scale * k, W, H,
                                        self.platesize, lensmap=lensmap,
                                        device=self.device)
        if (ray_table.width_px, ray_table.height_px) != (W, H):
            raise ValueError(
                f"ray table is {ray_table.width_px}x{ray_table.height_px}, "
                f"kernel build grid is {W}x{H}")
        self.ray_table = ray_table.device(self.device)
        self.background = background_tensor(background, self.height_px,
                                             self.width_px, self.device)
        self.script = plate_resolver_mode(globe) == "script"
        self._script_plan = None  # (batch, poses a piece of the script's evaluation)

    def _script_piece(self, batch):
        """The poses a piece of the script's evaluation takes in a call of
        *batch* poses.  Free memory is read at the first call and again only
        for a batch above the one last planned, so that calls of one size
        evaluate in the same pieces whatever the caching allocator kept
        from the call before (a Session keeps one kernel a key)."""
        if self._script_plan is None or batch > self._script_plan[0]:
            self._script_plan = (batch, script_piece(self.ray_table))
        return self._script_plan[1]

    def __call__(self, frames, bases):
        src, bases, expanded = prep_posed_inputs(
            frames, bases, self.platesize, self.background, self.device)
        plates = None
        if self.script:
            plates = script_pose_plates(self.ray_table, bases, self.globe,
                                        self._script_piece(int(bases.shape[0])))
        out = static_ray_posed(src, self.ray_table, bases, self.globe,
                               self.platesize, self.numcells, self.cell_size,
                               self.pad_size, expanded, self.background,
                               self.render_scale, plates=plates)
        return out.view(torch.uint32) if out.dtype == torch.int32 else out
