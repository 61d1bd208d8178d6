"""blinky_tpu_torch: the PyTorch/CUDA port of blinky-tpu.

A second package beside :mod:`blinky_tpu`, with the same module layout and
names, so that each ported function sits at the same path as its JAX
original.  Host-side code (palette, geometry, globes, lenses, the exact
float64 lensmap builder, the console ``Session``) is NumPy; the per-frame
device work runs through hand-written CUDA kernels for Hopper
(``csrc/*.cu``, built with ``nvcc`` at first use by
:mod:`blinky_tpu_torch.kernels._build`), each with a plain PyTorch version
beside it that serves tensors on the CPU.

This package never imports ``jax`` or ``blinky_tpu``.  Every entry point
that touches tensors takes a ``device``, ``"cuda"`` unless the caller asks
for the CPU; nothing probes for a card and nothing falls back.

    >>> import blinky_tpu_torch as bt
    >>> sess = bt.Session(640, 480)        # on "cuda"
    >>> out = sess.render(frames)          # [6,S,S,B] u8 -> [H,W,B] u8
    >>> posed = sess.render_posed(frames, poses)   # [B,3] degrees -> [B,H,W]
"""

__version__ = "0.1.0"

import torch

from blinky_tpu_torch import geometry, palette  # noqa: F401,E402


def device(name="cuda") -> torch.device:
    """``torch.device(name)``, the card unless *name* says otherwise; no
    probing."""
    return torch.device(name)


def __getattr__(name):
    # Lazy: the Session pulls in the lensmap builder and the kernels.
    if name == "Session":
        from blinky_tpu_torch.api import Session

        return Session
    raise AttributeError(name)
