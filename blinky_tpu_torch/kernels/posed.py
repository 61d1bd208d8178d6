"""Per-frame-pose playback: the posed inputs and the shared gather tail.

The port of :mod:`blinky_tpu.kernels.posed`.  A posed call renders every
frame of a batch at its own view rotation::

    frames [P, S, S, B] + bases [B, 3, 3]  ->  screens [B, H, W]

:func:`prep_posed_inputs` lays the frames out pose-major, ``[B, P*S*S]``, so
that pose ``b`` gathers from its own frame: through K7, the hand-written
CUDA kernel ``blinky_posed_layout`` (``csrc/layout.cu``), on a card, and
through its plain version, :func:`posed_layout_plain`, on the CPU.
:func:`gather_posed` is the
posed pipelines' gather tail (D): per-pose index tables -> screens, with
the nearest upsample by the render scale and the background select.  It
launches K5, the hand-written CUDA kernel ``blinky_posed_gather``
(``csrc/posed.cu``), for tensors on a card, and runs its plain version,
:func:`gather_posed_plain`, for tensors on the CPU.  The static-ray
pipeline (:mod:`blinky_tpu_torch.kernels.static_ray`) fuses the same tail
behind its per-pose index math in K6.  :class:`PosedRemapKernel`, the JAX
package's fused vmapped builder, is the float32 lens stage followed by K6:
the lens stage does not depend on the pose.  :func:`zoom_sweep_remap`
renders a whole zoom ramp of one frame: the float32 lens stage over the
ramp's scales, then K9, the hand-written CUDA kernel ``blinky_sweep_remap``
(``csrc/posed.cu``), on a card, or its plain version,
:func:`sweep_remap_plain`, on the CPU.

Sources follow :mod:`blinky_tpu_torch.kernels.remap`: plain u8 plates, the
expanded [12, ...] (raw||tinted) layout, or packed RGBA, carried as int32
bits inside the port and as ``torch.uint32`` at its boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch.budget import feasible_batch, sweep_bytes_per_lane
from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.kernels.remap import frames_tensor
from blinky_tpu_torch.palette import MAX_PLATES
from blinky_tpu_torch.utils.timing import span, spanned


def check_render_scale(width_px: int, height_px: int, k: int) -> None:
    """Validate a render_scale against a screen size (single source of
    truth for the kernel and the Session).  Raises ValueError."""
    if k < 1:
        raise ValueError("render_scale must be >= 1")
    if width_px % k or height_px % k:
        raise ValueError(
            f"screen {width_px}x{height_px} not divisible by "
            f"render_scale {k}")
    if k > 1 and ((width_px // k) % 2 or (height_px // k) % 2):
        # the every-k-th-ray identity needs k*(W'//2) == W//2, which
        # fails for odd W'/H' (the builder centers with C int division)
        # -- the k-scaled render would pan ~k/2 px
        raise ValueError(
            f"render_scale {k} leaves an odd "
            f"{width_px // k}x{height_px // k} build grid; "
            "pick k with even width/k and height/k")


def flat_gather_safe(batch: int, n_per_frame: int) -> bool:
    """Whether a flat global gather's ``b*N + idx`` would fit int32: the
    boundary any flattened index space must respect.  The port's kernels
    take a 64-bit source offset per pose, so they never meet it."""
    return batch * n_per_frame < 2**31


def prep_posed_inputs(frames, bases, platesize, background, device):
    """Validate and lay out a posed call's inputs on *device* (shared by
    the static-ray kernel and anything reintroducing the fused builder).

    ``frames`` [P, S, S, B] (NumPy or tensor; P <= 6 plates zero-padded to
    6, or the expanded 12); ``bases`` [B, 3, 3] (forward, right, up rows),
    cast to float32 as the JAX code does; ``background`` the kernel's [H, W]
    tensor, u8 or int32 (packed RGBA bits).  Returns ``(src [B, N], bases
    [B, 3, 3] f32, expanded)``: ``src`` pose-major, u8 or int32 bits, laid
    out by :func:`posed_layout` (K7 on a card).  Frames that already are
    pose-major (one pose of 6 or 12 contiguous planes, or a ``[B, P, S, S]``
    tensor permuted to ``[P, S, S, B]``) are used in place: ``src`` is a view
    of them, with no copy and no launch.  Any other layout is laid out by K7.
    """
    frames, is_rgba = frames_tensor(frames)
    P, S, _, B = frames.shape
    if S != platesize:
        raise ValueError(f"frames platesize {S} != kernel platesize {platesize}")
    expanded = P == 2 * MAX_PLATES
    if not expanded and P > MAX_PLATES:
        raise ValueError(f"{P} source planes: expected <= {MAX_PLATES} "
                         f"or {2 * MAX_PLATES}")
    with span("posed.upload"):  # a pageable upload waits for the card's queue
        bases = torch.as_tensor(np.asarray(bases) if not isinstance(bases, torch.Tensor)
                                else bases).to(device=device, dtype=torch.float32)
    if tuple(bases.shape) != (B, 3, 3):
        raise ValueError(f"bases must be [B={B}, 3, 3], got {tuple(bases.shape)}")
    if is_rgba and background.dtype != torch.int32:
        raise ValueError("RGBA frames need an RGBA (uint32) background")
    if not is_rgba and background.dtype == torch.int32:
        # the reverse mismatch would mix palette indices with packed RGBA
        raise ValueError("u8 frames need a u8 (palette-index) "
                         "background, got uint32")
    planes = P if expanded else MAX_PLATES
    frames = frames.to(device)
    pose_major = frames.permute(3, 0, 1, 2)
    if P == planes and pose_major.is_contiguous():
        # a whole frame set that already lies pose after pose: the
        # pose-major array is the frames themselves, so no copy is made
        return pose_major.reshape(B, -1), bases.contiguous(), expanded
    return posed_layout(frames, planes), bases.contiguous(), expanded


def posed_layout_plain(frames, planes):
    """K7's plain version: ``frames`` [P, S, S, B] -> pose-major
    [B, planes*S*S], planes P..planes-1 zero (the counterpart of
    ``jnp.transpose`` in ``blinky_tpu.kernels.posed.prep_posed_inputs``)."""
    P, S, _, B = frames.shape
    alloc = torch.empty if planes == P else torch.zeros
    src = alloc((B, planes, S, S), dtype=frames.dtype, device=frames.device)
    src[:, :P].copy_(frames.permute(3, 0, 1, 2))
    return src.reshape(B, -1)


# K7's long-row path (``layout.cu``'s note): rows at least as long as one
# block's run of a row, 128 bytes of u8 and 256 of RGBA; on shorter rows the
# vector path is as fast or faster (measured on the H100)
LONG_ROW_MIN_BYTES = {1: 128, 4: 256}


def long_row_path(elem_bytes: int, row_bytes: int, ld_bytes: int, out_row_bytes: int,
                  src_ptr: int, out_ptr: int) -> bool:
    """Whether K7 runs on its long-row path: texel rows of *elem_bytes*
    elements (1 or 4) of at least :data:`LONG_ROW_MIN_BYTES` for that size,
    the rows, their stride and the output's pose rows multiples of 16 bytes,
    with the frames and the output on 16-byte boundaries (the vector path's
    shapes).  The one place that decides: :func:`posed_layout` launches the
    path's entry point and counts ``posed_layout.long_row_launches`` on its
    answer."""
    return (row_bytes >= LONG_ROW_MIN_BYTES[elem_bytes] and row_bytes % 16 == 0
            and ld_bytes % 16 == 0 and out_row_bytes % 16 == 0 and src_ptr % 16 == 0
            and out_ptr % 16 == 0)


def posed_layout(frames, planes):
    """K7, the pose-major layout: ``frames`` [P, S, S, B] u8 or int32 bits
    -> [B, planes*S*S], planes P..planes-1 zero-filled.

    Launches K7 (``csrc/layout.cu``) for a tensor on a card and runs
    :func:`posed_layout_plain` for one on the CPU.  On a card, frames whose
    texels are evenly strided with the batch innermost and unit-strided, as
    a contiguous array or a batch slice of one (``frames[..., lo:hi]``) is,
    take ``blinky_posed_layout``, the tiled transpose; any other dense or
    strided layout (a transpose of the plate axes, say) takes
    ``blinky_posed_layout_strided``, which reads each element at its own
    four strides.  Long texel rows take the tiled transpose's long-row
    path (:func:`long_row_path`), counted in ``posed_layout.long_row_launches``
    beside ``posed_layout.launches``.
    """
    name = "posed_layout"
    P, S, _, B = frames.shape
    if frames.dtype not in (torch.uint8, torch.int32) or planes < P:
        raise ValueError(f"{name}: u8 or int32 frames of at most {planes} planes, got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if not _build.on_card(name, frames.device):
        return posed_layout_plain(frames, planes)
    T = P * S * S
    try:
        rows = frames.view(T, B)  # texel t's poses at t * ld + [0, B)
    except RuntimeError:
        rows = None
    if rows is not None and B > 1 and rows.stride(1) != 1:
        rows = None
    if rows is None and any(st < 0 for st in frames.stride()):
        raise ValueError(f"{name}: frames of strides {frames.stride()}: negative strides")
    with _build.on_device(frames.device) as stream:
        out = torch.empty((B, planes * S * S), dtype=frames.dtype, device=frames.device)
        if out.numel():
            if rows is None:
                _build.launch(posed_layout, name, "blinky_posed_layout_strided",
                    frames.data_ptr(), *frames.stride(), P, S, B, frames.element_size(),
                    planes * S * S, out.data_ptr(), stream)
            else:
                ld = max(rows.stride(0), B)  # a single texel's stride is free
                el = frames.element_size()
                long_rows = long_row_path(el, B * el, ld * el, planes * S * S * el,
                                          rows.data_ptr(), out.data_ptr())
                _build.launch(posed_layout, name,
                    "blinky_posed_layout_rows" if long_rows else "blinky_posed_layout",
                    rows.data_ptr(), ld, T, B, el, planes * S * S, out.data_ptr(), stream)
                posed_layout.long_row_launches += long_rows
    return out


posed_layout.launches = 0
posed_layout.long_row_launches = 0


def _upsample(t, k):
    return t if k == 1 else t.repeat_interleave(k, 1).repeat_interleave(k, 2)


def gather_posed_plain(src, idx, valid, background, k):
    """K5's plain version, ``blinky_tpu.kernels.posed.gather_posed``:
    ``out[b, y, x] = valid' ? src[b, clip(idx'[b], 0, N-1)] : bg[y, x]``
    with ``idx'``/``valid'`` the [B, H/k, W/k] tables nearest-upsampled
    by *k* -> [B, H, W]."""
    B, N = src.shape
    g = torch.gather(src, 1, idx.reshape(B, -1).long().clamp(0, N - 1))
    g = _upsample(g.reshape(idx.shape), k)
    return torch.where(_upsample(valid, k), g, background)


def check_gather_operands(kernel, src, hb, wb, background, k, idx=None, valid=None):
    """The checks K5 and K6 share on their source, their [B, hb, wb]
    tables (K5's only) and their [hb*k, wb*k] background."""
    if (src.dtype not in (torch.uint8, torch.int32) or src.dim() != 2
            or not src.is_contiguous() or src.shape[1] < 1):
        raise ValueError(f"{kernel}: src must be a contiguous [B, N >= 1] u8 or "
                         f"int32 tensor, got {src.dtype} {tuple(src.shape)}")
    if int(k) < 1:
        raise ValueError(f"{kernel}: render scale k must be >= 1, got {k}")
    B = src.shape[0]
    for name, t, dtype, shape in (("idx", idx, torch.int32, (B, hb, wb)),
                                  ("valid", valid, torch.bool, (B, hb, wb)),
                                  ("background", background, src.dtype,
                                   (hb * k, wb * k))):
        if t is None:
            continue
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != src.device):
            raise ValueError(
                f"{kernel}: {name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on {src.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def gather_posed(src, idx, valid, background, k):
    """K5, D of the posed pipelines: per-pose index tables -> screens.

    ``src`` [B, N] u8 or int32 (packed RGBA bits), pose-major as
    :func:`prep_posed_inputs` lays it out; ``idx`` [B, H/k, W/k] int32;
    ``valid`` [B, H/k, W/k] bool; ``background`` [H, W] of src's dtype;
    ``k >= 1`` the render scale.  Returns [B, H, W] (see
    :func:`gather_posed_plain`).
    """
    name = "gather_posed"
    hb, wb = idx.shape[-2:]
    check_gather_operands(name, src, hb, wb, background, k, idx, valid)
    if not _build.on_card(name, src.device):
        return gather_posed_plain(src, idx, valid, background, k)
    B, N = src.shape
    with _build.on_device(src.device) as stream:
        out = torch.empty((B, hb * k, wb * k), dtype=src.dtype, device=src.device)
        if out.numel():
            _build.launch(gather_posed, "posed_gather", "blinky_posed_gather",
                src.data_ptr(), N, src.element_size(), B, idx.data_ptr(),
                valid.data_ptr(), background.data_ptr(), int(k), hb, wb,
                out.data_ptr(), stream)
    return out


gather_posed.launches = 0


@spanned("posed.bases")
def bases_from_pose_track(poses) -> np.ndarray:
    """[B, 3] (pitch, yaw, roll) degrees -> [B, 3, 3] float64 bases, rows
    (forward, right, up)."""
    from blinky_tpu_torch.camera import view_basis_from_angles

    out = np.empty((len(poses), 3, 3), np.float64)
    for i, (p, y, r) in enumerate(np.asarray(poses, dtype=np.float64)):
        f, rt, u = view_basis_from_angles(p, y, r)
        out[i, 0], out[i, 1], out[i, 2] = f, rt, u
    return out


class PosedRemapKernel:
    """Per-frame-pose playback kernel for one (lens, globe, screen shape):
    the port of ``blinky_tpu.kernels.posed.PosedRemapKernel``, the fused
    vmapped float32 builder and gather.

    Usage::

        k = PosedRemapKernel(lens, globe, W, H, scale, device="cuda")
        out = k(frames, bases)   # [P, S, S, B] + [B, 3, 3] -> [B, H, W]

    ``bases[b]`` rows are (forward, right, up).  ``frames`` may be the plain
    [<=6, S, S, B] u8 source, the expanded [12, S, S, B] layout, or either
    as packed RGBA u32.

    The JAX pipeline evaluates the lens once per pose under ``vmap``, but
    the lens stage does not depend on the pose.  So the port runs the
    float32 lens stage once, at ``scale * render_scale`` on the
    ``W/k x H/k`` build grid on *device*, and every call is K7 and K6: this
    is :class:`blinky_tpu_torch.kernels.static_ray.StaticRayPosedKernel` on
    a ray table from the float32 lens stage, which gives the same values,
    and no per-pose table is written.  Its attributes (``lens``, ``globe``,
    ``width_px``, ``render_scale``, ``background``, ``ray_table``, ...) are
    that kernel's.
    """

    def __init__(self, lens, globe, width_px, height_px, scale,
                 platesize=None, numcells=10, cell_size=4.0, pad_size=1.0,
                 background=None, dtype=None, render_scale=1, *, device="cuda"):
        from blinky_tpu_torch.kernels.static_ray import (
            StaticRayPosedKernel, ray_table_from_lens,
        )

        if getattr(lens, "map_type", "inverse") != "inverse":
            raise ValueError(
                "PosedRemapKernel fuses the vmapped INVERSE builder; "
                f"lens '{getattr(lens, 'name', lens)}' is forward-only — "
                "Session.render_posed falls back to per-pose exact host "
                "builds for these")
        if dtype not in (None, torch.float32):
            raise ValueError(f"PosedRemapKernel builds in float32, not {dtype}")
        self.dtype = torch.float32
        k = int(render_scale)
        check_render_scale(int(width_px), int(height_px), k)
        table = ray_table_from_lens(lens, float(scale) * k, int(width_px) // k,
                                    int(height_px) // k, backend="torch", device=device)
        self._static = StaticRayPosedKernel(
            lens, globe, width_px, height_px, scale, platesize, numcells, cell_size,
            pad_size, background, render_scale, ray_table=table, device=device)

    def __getattr__(self, name):
        # only reached when normal lookup fails: the static-ray kernel's
        if name == "_static":
            raise AttributeError(name)
        return getattr(self._static, name)

    def __call__(self, frames, bases):
        return self._static(frames, bases)


def sweep_remap_plain(src, vx, vy, vz, lens_valid, globe, platesize, numcells,
                      cell_size, pad_size, expanded, background, plates=None):
    """K9's plain version: per zoom step,
    :func:`blinky_tpu_torch.lensmap.builder.rays_to_lensmap_torch` of the
    step's rays with NO rotation (a script globe's *plates* given,
    [steps, H, W]), the expanded source's tinted-half offset, the clipped
    gather from the one source and the background select (``one_scale`` of
    ``blinky_tpu.kernels.posed._compiled_sweep_pipeline``) -> [N, H, W]."""
    from blinky_tpu_torch.lensmap.builder import TINT_NONE, rays_to_lensmap_torch

    S = platesize
    N = src.shape[0]
    outs = []
    for n in range(vx.shape[0]):
        lm = rays_to_lensmap_torch(globe, vx[n], vy[n], vz[n], lens_valid[n], S,
                                   numcells, cell_size, pad_size,
                                   plate=None if plates is None else plates[n])
        idx, valid = lm["flat_idx"], lm["valid"]
        if expanded:
            idx = idx + torch.where((lm["tint"] != TINT_NONE) & valid,
                                    MAX_PLATES * S * S, 0).to(torch.int32)
        g = torch.gather(src, 0, idx.reshape(-1).long().clamp(0, N - 1))
        outs.append(torch.where(valid, g.reshape(idx.shape), background))
    return torch.stack(outs)


def sweep_remap(src, vx, vy, vz, lens_valid, globe, platesize, numcells,
                cell_size, pad_size, expanded, background, plates=None):
    """K9, the fused zoom sweep's resolve and gather: a ray table a zoom
    step -> a screen a step, all from ONE source frame, with no rotation.

    ``src`` [N] u8 or int32 (packed RGBA bits), N = 6·S² or 12·S² when
    *expanded*; ``vx, vy, vz`` contiguous f32 and ``lens_valid`` contiguous
    bool, [steps, H, W]; ``background`` [H, W] of src's dtype.  A script
    globe resolves in mode 2 from *plates*, a contiguous int8 [steps, H, W]
    tensor, by default its resolver on the normalized rays (K13 with no
    rotation, then :func:`blinky_tpu_torch.lensmap.builder.script_plates`).
    Returns [steps, H, W] (see :func:`sweep_remap_plain`).
    """
    from blinky_tpu_torch.lensmap.builder import (
        RESOLVERS, grid_line_words, resolver_args, rotate_rays, script_plates,
    )

    name = "sweep_remap"
    dev = src.device
    S = int(platesize)
    want = (2 if expanded else 1) * MAX_PLATES * S * S
    if (src.dtype not in (torch.uint8, torch.int32) or src.dim() != 1
            or not src.is_contiguous() or src.numel() != want):
        raise ValueError(f"{name}: src must be a contiguous [{want}] u8 or int32 tensor "
                         f"(platesize {S}{', expanded' if expanded else ''}), got "
                         f"{src.dtype} {tuple(src.shape)}")
    shape = tuple(vx.shape)
    for what, t, dtype, shp in (("vx", vx, torch.float32, shape), ("vy", vy, torch.float32, shape),
                                ("vz", vz, torch.float32, shape),
                                ("lens_valid", lens_valid, torch.bool, shape),
                                ("background", background, src.dtype, shape[1:])):
        if (t.dtype != dtype or tuple(t.shape) != shp or len(shape) != 3
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(
                f"{name}: {what} must be a contiguous {dtype} tensor of shape {shp} "
                f"([steps, H, W] rays) on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    globe_args = resolver_args(globe)  # a non-jittable globe raises here
    if globe_args[2] == RESOLVERS["script"]:
        if plates is None:
            plates = script_plates(globe, *rotate_rays(vx, vy, vz)).clamp(
                -1, MAX_PLATES).to(torch.int8)
        if (plates.dtype != torch.int8 or tuple(plates.shape) != shape
                or not plates.is_contiguous() or plates.device != dev):
            raise ValueError(f"{name}: plates must be a contiguous int8 {shape} tensor on "
                             f"{dev}, got {plates.dtype} {tuple(plates.shape)}")
    else:
        plates = None
    if not _build.on_card(name, dev):
        return sweep_remap_plain(src, vx, vy, vz, lens_valid, globe, S, numcells,
                                 cell_size, pad_size, expanded, background, plates)
    with _build.on_device(dev) as stream:
        out = torch.empty(shape, dtype=src.dtype, device=dev)
        if out.numel():
            consts, nplates, resolver, fast_dist, fast_half = globe_args
            lines = (grid_line_words(S, float(numcells), float(cell_size), float(pad_size),
                                     dev) if expanded else None)
            _build.launch(sweep_remap, name, "blinky_sweep_remap",
                vx.data_ptr(), vy.data_ptr(), vz.data_ptr(), lens_valid.data_ptr(),
                shape[1] * shape[2], shape[0], consts.ctypes.data, nplates, resolver,
                fast_dist, fast_half, _build.ptr(plates), _build.ptr(lines), S,
                int(expanded), src.data_ptr(),
                src.numel(), src.element_size(), background.data_ptr(), out.data_ptr(),
                stream)
            sweep_remap.given_launches += resolver == RESOLVERS["script"]
    return out


sweep_remap.launches = 0
sweep_remap.given_launches = 0  # the launches in resolver mode 2 (a script globe)


def zoom_sweep_remap(lens, globe, scales, frame, width_px, height_px,
                     numcells=10, cell_size=4.0, pad_size=1.0,
                     background=None, dtype=None, *, device="cuda"):
    """Render a whole zoom ramp of ONE frame in one fused pass: the port of
    ``blinky_tpu.kernels.posed.zoom_sweep_remap``.

    ``scales``: [N] lens-plane scales (one per sweep step, from
    :func:`blinky_tpu_torch.lensmap.calc_scale`); ``frame``: one [P, S, S]
    u8/u32 source (plain or the expanded raw||tinted rubix layout), a NumPy
    array or a tensor.  Returns an [N, H, W] tensor on *device*
    (``torch.uint32`` for RGBA).

    The float32 lens stage runs over the whole scale axis at once, as the
    JAX package vmaps it, then :func:`sweep_remap` (K9 on a card) resolves
    and gathers every step; no rotation is applied, so the result equals a
    per-step loop of ``Session(backend="torch")`` bit for bit.  A ramp
    whose ray tables would not fit the device's memory budget runs in
    chunks of steps.
    """
    from blinky_tpu_torch.kernels.static_ray import background_tensor
    from blinky_tpu_torch.lensmap.builder import lens_rays_torch, plate_resolver_mode

    if getattr(lens, "map_type", "inverse") != "inverse":
        raise ValueError(
            "zoom_sweep_remap vmaps the INVERSE builder over the scale "
            f"axis; lens '{getattr(lens, 'name', lens)}' is forward-only — "
            "sweep it per step through Session.cmd/render (cli sweep does)")
    if dtype not in (None, torch.float32):
        raise ValueError(f"zoom_sweep_remap builds in float32, not {dtype}")
    script = plate_resolver_mode(globe) == "script"  # a non-jittable globe raises
    dev = torch.device(device)
    frame, is_rgba = frames_tensor(frame)
    P, S, _ = frame.shape
    expanded = P == 2 * MAX_PLATES
    if not expanded and P > MAX_PLATES:
        raise ValueError(f"{P} source planes: expected <= {MAX_PLATES} "
                         f"or {2 * MAX_PLATES}")
    width_px, height_px = int(width_px), int(height_px)
    bg = background_tensor(background, height_px, width_px, dev)
    if is_rgba and bg.dtype != torch.int32:
        raise ValueError("RGBA frames need an RGBA (uint32) background")
    if not is_rgba and bg.dtype == torch.int32:
        raise ValueError("u8 frames need a u8 (palette-index) background, "
                         "got uint32")
    frame = frame.to(dev)
    if not expanded and P != MAX_PLATES:
        frame = torch.cat([frame, frame.new_zeros((MAX_PLATES - P, S, S))])
    src = frame.contiguous().reshape(-1)
    scales = torch.as_tensor(np.asarray(scales, np.float64), dtype=torch.float32, device=dev)
    chunk = feasible_batch(sweep_bytes_per_lane(width_px, height_px, is_rgba, script), 0,
                           device=dev)
    outs = []
    for lo in range(0, scales.numel(), chunk):
        rays = lens_rays_torch(lens, scales[lo:lo + chunk], width_px, height_px, dev)
        outs.append(sweep_remap(src, *rays, globe, S, float(numcells), float(cell_size),
                                float(pad_size), expanded, bg))
        del rays
    if not outs:  # no steps: nothing to build or gather
        outs = [torch.empty((0, height_px, width_px), dtype=src.dtype, device=dev)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out.view(torch.uint32) if is_rgba else out
