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
behind its per-pose index math in K6.

Sources follow :mod:`blinky_tpu_torch.kernels.remap`: plain u8 plates, the
expanded [12, ...] (raw||tinted) layout, or packed RGBA, carried as int32
bits inside the port and as ``torch.uint32`` at its boundary.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.kernels.remap import frames_tensor
from blinky_tpu_torch.palette import MAX_PLATES


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
    out by :func:`posed_layout` (K7 on a card).  For one pose of 6 or 12
    contiguous planes ``src`` is a view of the frames: no copy, no launch.
    """
    frames, is_rgba = frames_tensor(frames)
    P, S, _, B = frames.shape
    if S != platesize:
        raise ValueError(f"frames platesize {S} != kernel platesize {platesize}")
    expanded = P == 2 * MAX_PLATES
    if not expanded and P > MAX_PLATES:
        raise ValueError(f"{P} source planes: expected <= {MAX_PLATES} "
                         f"or {2 * MAX_PLATES}")
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
    if B == 1 and P == planes and frames.is_contiguous():
        # one pose of a whole, contiguous frame set: the pose-major array is
        # the frames themselves, so no copy is made
        return frames.reshape(1, -1), bases.contiguous(), expanded
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


def posed_layout(frames, planes):
    """K7, the pose-major layout: ``frames`` [P, S, S, B] u8 or int32 bits
    -> [B, planes*S*S], planes P..planes-1 zero-filled.

    Launches ``blinky_posed_layout`` (``csrc/layout.cu``) for a tensor on a
    card and runs :func:`posed_layout_plain` for one on the CPU.  On a card
    the frames' texels must be evenly strided with the batch innermost and
    unit-strided, as a contiguous array or a batch slice of one
    (``frames[..., lo:hi]``) is; any other layout raises.
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
    if rows is None or (B > 1 and rows.stride(1) != 1):
        raise ValueError(f"{name}: frames of strides {frames.stride()} are not evenly "
                         "strided texels with a unit-strided batch; pass a contiguous "
                         "array or a batch slice of one")
    ld = max(rows.stride(0), B)  # a single texel's stride is free
    out = torch.empty((B, planes * S * S), dtype=frames.dtype, device=frames.device)
    if out.numel():
        lib = _build.library()
        with torch.cuda.device(frames.device):
            rc = lib.blinky_posed_layout(rows.data_ptr(), ld, T, B, frames.element_size(),
                                         planes * S * S, out.data_ptr(),
                                         _build.stream(frames.device))
        _build.check(rc, name)
        posed_layout.launches += 1
    return out


posed_layout.launches = 0


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
    out = torch.empty((B, hb * k, wb * k), dtype=src.dtype, device=src.device)
    if out.numel():
        lib = _build.library()
        with torch.cuda.device(src.device):
            rc = lib.blinky_posed_gather(
                src.data_ptr(), N, src.element_size(), B, idx.data_ptr(),
                valid.data_ptr(), background.data_ptr(), int(k), hb, wb,
                out.data_ptr(), _build.stream(src.device))
        _build.check(rc, name)
        gather_posed.launches += 1
    return out


gather_posed.launches = 0


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
    """``blinky_tpu.kernels.posed.PosedRemapKernel`` (the fused vmapped
    float32 builder + gather) is not ported: it waits for the float32
    device builder.  :class:`blinky_tpu_torch.kernels.static_ray.
    StaticRayPosedKernel` serves the posed path."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "PosedRemapKernel waits for the float32 device lensmap builder, "
            "which is not ported to blinky_tpu_torch yet; use "
            "StaticRayPosedKernel")


def posed_remap_sharded(*args, **kwargs):
    """Not ported: the pose-sharded posed pipeline waits for multi-GPU."""
    raise NotImplementedError(
        "posed_remap_sharded waits for multi-GPU support, which is not "
        "ported to blinky_tpu_torch yet")


def zoom_sweep_remap(*args, **kwargs):
    """Not ported: the fused zoom sweep waits for its own slice."""
    raise NotImplementedError(
        "zoom_sweep_remap (the fused zoom sweep) is not ported to "
        "blinky_tpu_torch yet")
