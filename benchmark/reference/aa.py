"""Supersampled true colour: the palette decode, the remap at *factor*
times the screen, and the box filter back down (``Session.render_aa``).

* The decode: each u8 palette index becomes the packed RGBA word of its
  palette entry, red in the low byte, then green, then blue, and alpha
  0xFF in the high byte, held as the word's int32 bits.
* The remap: the lensmap of :func:`benchmark.reference.lensmap.build` at
  ``factor * width`` by ``factor * height``, each valid pixel showing the
  texel it names and every other pixel the background, a u8 image of the
  screen's size (zeros without one) repeated ``factor`` times along each
  axis and decoded.
* The box filter: per channel the integer sum over each ``factor`` by
  ``factor`` block, divided by ``factor**2`` in float32 (a true division,
  by a float32 tensor), + 0.5, clamped to 0..255 and truncated; alpha
  0xFF.

Where this differs from ``render_aa`` in order, not in value:

* it gathers the u8 indices first and decodes the gathered texels, where
  ``render_aa`` decodes every plane and then gathers the words: a decode
  is a lookup a texel, so both give the same words, and this way a check
  holds one block of lanes of the supersampled screen, never a decoded
  batch of planes;
* it works a block of lanes at a time (:data:`BLOCK`), where the program
  renders a whole batch in one call;
* it takes no expanded (rubix) source and no packed-RGBA frames, which the
  benchmark does not drive.

The precision of the lensmap's double stages is an argument (*hi*), as in
:func:`benchmark.reference.lensmap.build`, so that the same code serves as
the control one precision down.
"""

from __future__ import annotations

import torch

from . import lensmap as ref_lensmap

BLOCK = 16  # lanes a reference screen is worked out for at once
ALPHA = 0xFF << 24


def _bits(word):
    """Unsigned 32-bit words (int64) -> their int32 bits."""
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


def rgba_table(palette, device="cpu"):
    """The decode table of *palette* ``[256, 3]`` u8 (r, g, b): ``[256]``
    int32 bits of ``r | g << 8 | b << 16 | 0xFF << 24``."""
    p = torch.as_tensor(palette).to(device=device, dtype=torch.int64)
    return _bits(p[:, 0] | (p[:, 1] << 8) | (p[:, 2] << 16) | ALPHA)


def lensmap(cfg: dict, factor: int, *, hi=torch.float64, device="cpu"):
    """(flat_idx, valid) of the configuration's lens and globe at
    ``factor`` times its screen."""
    k = int(factor)
    return ref_lensmap.build(cfg["lens"], cfg["globe"], cfg["fov"], k * cfg["width"],
                             k * cfg["height"], cfg["platesize"], hi=hi, device=device)


def box(hi, factor: int):
    """``[k*H, k*W, L]`` int32 words -> ``[H, W, L]``: each channel's k x k
    mean, rounded half up, alpha 0xFF."""
    k = int(factor)
    kH, kW = hi.shape[:2]
    H, W = kH // k, kW // k
    count = torch.tensor(float(k * k), dtype=torch.float32, device=hi.device)
    out = torch.full((H, W) + tuple(hi.shape[2:]), ALPHA, dtype=torch.int64, device=hi.device)
    for shift in (0, 8, 16):
        c = ((hi.to(torch.int64) >> shift) & 0xFF).reshape((H, k, W, k) + tuple(hi.shape[2:]))
        mean = c.sum(dim=(1, 3)).to(torch.float32) / count
        out |= (mean + 0.5).clamp(0, 255).to(torch.int64) << shift
    return _bits(out)


def screens(frames, table, flat, valid, width: int, height: int, factor: int,
            start: int = 0, stop=None, background=None):
    """The screens of lanes ``start:stop`` of *frames* ``[P, S, S, B]`` u8
    through the supersampled lensmap (*flat*, *valid* over ``factor *
    height`` by ``factor * width`` pixels): ``[height * width, lanes]``
    int32 words, row-major over the screen."""
    k = int(factor)
    B = frames.shape[-1]
    stop = B if stop is None else stop
    rows = frames.reshape(-1, B)[:, start:stop]
    dev = rows.device
    table = table.to(dev)
    texels = rows.index_select(0, flat.to(dev))  # [kH*kW, lanes] u8
    words = table[texels.to(torch.int64)]
    if background is None:
        bg = torch.zeros((height, width), dtype=torch.uint8, device=dev)
    else:
        bg = torch.as_tensor(background, dtype=torch.uint8).to(dev)
    bg = bg.repeat_interleave(k, 0).repeat_interleave(k, 1).reshape(-1)
    words = torch.where(valid.to(dev)[:, None], words, table[bg.to(torch.int64)][:, None])
    return box(words.reshape(k * height, k * width, -1), k).reshape(height * width, -1)


class AA:
    """The configuration's supersampled screens at its ``factor`` through
    *palette*, with no background image, the lensmap built once."""

    def __init__(self, cfg: dict, palette, *, hi=torch.float64, device="cpu"):
        self.factor = int(cfg["factor"])
        self.shape = (cfg["height"], cfg["width"])
        self.flat, self.valid = lensmap(cfg, self.factor, hi=hi, device=device)
        self.table = rgba_table(palette, device)

    def screens(self, frames, start: int, stop: int):
        H, W = self.shape
        return screens(frames, self.table, self.flat, self.valid, W, H, self.factor,
                       start, stop)

    def __call__(self, frames):
        """``[H, W, B]`` int32 words of every lane of *frames*."""
        B = frames.shape[-1]
        out = torch.cat([self.screens(frames, a, min(a + BLOCK, B))
                         for a in range(0, B, BLOCK)], dim=1)
        return out.reshape(self.shape + (B,))
