"""Throughput of the static remap's headline shape and of the 360-video
chain on the card.

The port of :mod:`blinky_tpu.bench.throughput`'s headline: a 1080p panini +
cube ``f_fov 180`` batched remap over a texel-compacted source
(``kernels.remap.compact_texels``) made on the device, timed with CUDA
events, for K1 and for its plain version.  The batch is explicit; the
autobatch planner and the other source layouts are not ported yet.

And of its equirect chain (:func:`run_equirect_throughput`): a pano batch
made on the device (:func:`device_pano`) through the ingest and the remap in
one of their three formulations, in panos a second.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.bench.sol import cuda_ms
from blinky_tpu_torch.kernels.remap import (
    RemapKernel, compact_texels, remap_gather, remap_gather_plain,
)
from blinky_tpu_torch.palette import default_palette
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale


def device_source_texels(platesize, batch, rgba, texels, *, device="cuda",
                         chunk: int = 128):
    """Synthetic source in the texel-compacted layout of
    ``kernels.remap.compact_texels``, made on *device*: [R, B] u8, or the
    int32 bits of packed RGBA with *rgba*.  The values are
    ``blinky_tpu.bench.throughput.device_source_texels``'s: per texel
    (plane, py, px) and lane b, ``v = (p*40 + 8 + checker + grad) % 255``.
    Lanes are made *chunk* at a time to bound the int32 temporaries."""
    S = platesize
    t = torch.from_numpy(np.asarray(texels, np.int64)).to(device)
    p, py, px = (a.to(torch.int32) for a in (t // (S * S), t // S % S, t % S))
    base = (p * 40 + 8 + ((px // 8 + py // 8) % 2) * 16)[:, None]
    g0 = ((px * 3 + py * 5 + p * 37) % 128)[:, None]
    out = torch.empty((t.numel(), batch),
                      dtype=torch.int32 if rgba else torch.uint8, device=device)
    for b0 in range(0, batch, chunk):
        b = torch.arange(b0, min(b0 + chunk, batch), dtype=torch.int32,
                         device=device)[None, :]
        v = (base + (g0 + b * 11) % 128) % 255
        if rgba:
            # v | (v*3 % 256) << 8 | (v*7 % 256) << 16 | 0xFF << 24, as
            # int32 bits: alpha 0xFF sets the sign bit
            v = (v | ((v * 3 % 256) << 8) | ((v * 7 % 256) << 16)) - (1 << 24)
        out[:, b0:b0 + b.shape[1]] = v.to(out.dtype)
    return out


def run_gather_throughput(batch: int, *, device="cuda", iters: int = 10,
                          width: int = 1920, height: int = 1080,
                          platesize: int = 1080, lens_name: str = "panini",
                          globe_name: str = "cube", zoom=Zoom("fov", 180),
                          texel_compact: bool = True) -> dict:
    """K1 and its plain version (``index_select`` + ``where``) on the
    headline shape: the u8 texel-compacted source at *batch* lanes.

    Returns the config, ms per batch and frames/s of each, the bytes one
    batch moves (index, mask and background per pixel, one source row
    read and one output row written per pixel) with the achieved GB/s,
    and whether K1's output equals the plain version's bit for bit."""
    if not texel_compact:
        raise NotImplementedError(
            "only the texel-compacted source is ported; the full, "
            "plate-compacted and row-cropped sources are not yet")
    device = torch.device(device)
    g = globes.get(globe_name)
    lens = lenses.get(lens_name, g)
    scale = calc_scale(zoom, lens, width, height)
    lm = build_lensmap(lens, g, scale, width, height, platesize)
    texels, cidx = compact_texels(lm)
    frames = device_source_texels(platesize, batch, False, texels, device=device)
    idx = torch.from_numpy(cidx.reshape(-1)).to(device)
    valid = torch.from_numpy(lm.valid.reshape(-1)).to(device)
    bg = torch.zeros(idx.numel(), dtype=torch.uint8, device=device)

    out = remap_gather(frames, idx, valid, bg)
    ms = cuda_ms(lambda: remap_gather(frames, idx, valid, bg), iters)
    equal = bool(torch.equal(out, remap_gather_plain(frames, idx, valid, bg)))
    del out
    plain_ms = cuda_ms(lambda: remap_gather_plain(frames, idx, valid, bg), iters)
    npix = idx.numel()
    nbytes = npix * (4 + 1 + 1 + 2 * batch)
    return dict(
        config=f"{lens_name}+{globe_name} {width}x{height} S={platesize} "
        f"B={batch} texelcompact({texels.size}tx)",
        batch=batch, texels=int(texels.size), iters=iters,
        ms_per_batch=ms, fps=batch / (ms * 1e-3),
        plain_ms_per_batch=plain_ms, plain_fps=batch / (plain_ms * 1e-3),
        bytes_per_batch=nbytes, gbps=nbytes / (ms * 1e-3) / 1e9,
        plain_gbps=nbytes / (plain_ms * 1e-3) / 1e9, equal=equal,
    )


def device_pano(h: int, w: int, batch: int, *, device="cuda", chunk_rows: int = 256):
    """Synthetic [H, W, B] packed-RGBA ``torch.uint32`` pano batch made on
    *device*, with ``blinky_tpu.bench.throughput.device_pano``'s values:
    ``v = (3r + 5c + 11b) % 256`` in red, ``5v % 256`` in green, ``9v % 256``
    in blue, alpha 0xFF.  Rows are made *chunk_rows* at a time to bound the
    int32 temporaries (the 4096x2048 batch of 128 lanes is 4 GiB itself)."""
    device = torch.device(device)
    out = torch.empty((h, w, batch), dtype=torch.int32, device=device)
    c = torch.arange(w, dtype=torch.int32, device=device)[None, :, None] * 5
    b = torch.arange(batch, dtype=torch.int32, device=device)[None, None, :] * 11
    for r0 in range(0, h, chunk_rows):
        r = torch.arange(r0, min(r0 + chunk_rows, h), dtype=torch.int32,
                         device=device)[:, None, None] * 3
        v = (r + c + b) % 256
        # the alpha byte 0xFF sets the sign bit of the int32 word
        out[r0:r0 + r.shape[0]] = (v | ((v * 5 % 256) << 8) | ((v * 9 % 256) << 16)) - (1 << 24)
    return out.view(torch.uint32)


def run_equirect_throughput(pano_h=2048, pano_w=4096, platesize=720,
                            width=1280, height=720, batch=16, iters=4,
                            bilinear=True, rubix=False, lens_name="panini",
                            fov=180, texel_compact=False, fused=False, *,
                            device="cuda", panos=None) -> dict:
    """End-to-end 360-video throughput: a pano batch on the device through
    ``Session.render_equirect``, timed with CUDA events; only the warped
    screens would leave the card.  Rubix rides the post-gather tint.  With
    *texel_compact* the ingest resamples only the texels the lensmap
    references (the Session's ``"compact"`` mode); with *fused* the ingest's
    tables compose through the lensmap and pano -> screen is one launch of
    K10 (``"fused"``); with neither, the full faces are made and remapped
    (``"faces"``).  *panos* hands over a batch made earlier
    (``[pano_h, pano_w, batch]`` on *device*).  Returns the config, panos a
    second (``fps``) and ms a batch."""
    from blinky_tpu_torch.api import Session

    sess = Session(width, height, platesize=platesize, device=device)
    sess.cmd(f"f_lens {lens_name}")
    sess.cmd(f"f_fov {fov}")
    if rubix:
        sess.cmd("f_rubix")
    mode = "fused" if fused else "compact" if texel_compact else "faces"
    if panos is None:
        panos = device_pano(pano_h, pano_w, batch, device=device)
    ms = cuda_ms(lambda: sess.render_equirect(panos, bilinear=bilinear, mode=mode), iters)
    return dict(
        config=f"equirect {pano_w}x{pano_h} -> {lens_name} {width}x{height}"
        f" S={platesize} B={panos.shape[-1]}"
        + (" bilinear" if bilinear else " nearest")
        + (" rubix" if rubix else "")
        + (" fused" if fused else " texelcompact" if texel_compact else ""),
        fps=panos.shape[-1] / (ms * 1e-3),
        ms_per_batch=ms,
    )
