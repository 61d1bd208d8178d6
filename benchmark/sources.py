"""The benchmark's inputs, made from ``--seed``: cubemap frames and pano
batches on the card.  Same seed, same inputs; every seed gives the same
shapes and the same amount of work.

The shapes and layouts are those of the port's bench sources (batch
innermost: ``[6, S, S, B]`` frames, ``[H, W, B]`` packed-RGBA panos); the
values are uniform random bytes, so that a texel read from the wrong place
shows.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one input stream of a run, from the run's seed."""
    return int(np.random.SeedSequence([seed % 2**64, stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def random_bytes(shape, g: torch.Generator, device) -> torch.Tensor:
    """Uniform random u8 of *shape*, made where *g* lives in one call."""
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=device, generator=g)


def cubemap_batches(platesize: int, batch: int, ring: int, seed: int, device) -> list:
    """*ring* batches of u8 palette frames ``[6, S, S, B]`` on *device*."""
    g = generator(seed, 1, device)
    return [random_bytes((6, platesize, platesize, batch), g, device) for _ in range(ring)]


def pano_batches(pano_h: int, pano_w: int, batch: int, ring: int, seed: int, device) -> list:
    """*ring* batches of packed-RGBA panos ``[H, W, B]`` (``torch.uint32``)
    on *device*: four random bytes a texel."""
    g = generator(seed, 2, device)
    return [random_bytes((pano_h, pano_w, batch * 4), g, device).view(torch.int32)
            .view(torch.uint32) for _ in range(ring)]


class Reservoir:
    """A uniform sample of at most *size* of the items offered, drawn from
    *seed*: the window's outputs that the check compares."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed % 2**64, 5])
        self.seen = 0
        self.items = {}  # slot -> item

    def offer(self, item) -> None:
        self.seen += 1
        if self.seen <= self.size:
            self.items[self.seen - 1] = item
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.items[j] = item
