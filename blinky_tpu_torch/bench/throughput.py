"""Throughput of the static remap's headline shape on the card.

The port of :mod:`blinky_tpu.bench.throughput`'s headline: a 1080p panini +
cube ``f_fov 180`` batched remap over a texel-compacted source
(``kernels.remap.compact_texels``) made on the device, timed with CUDA
events, for K1 and for its plain version.  The batch is explicit; the
autobatch planner and the other source layouts are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.bench.sol import cuda_ms
from blinky_tpu_torch.kernels.remap import (
    compact_texels, remap_gather, remap_gather_plain,
)
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
