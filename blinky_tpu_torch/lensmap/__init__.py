"""Lensmap: the per-screen-pixel gather table and its builders.

Reference: the lensmap is ``lens.pixels`` — a per-pixel *pointer* into the
globe pixel store plus a per-pixel tint index (``engine/NQ/fisheye.c:
379-451``).  Here it is index arrays: a flat int32 gather index, a
validity mask and a compact tint plane, static per (lens, globe, zoom,
size) and consumed by the remap kernels every frame.
"""

from blinky_tpu_torch.lensmap.zoom import Zoom, ZoomError, calc_scale  # noqa: F401
from blinky_tpu_torch.lensmap.builder import (  # noqa: F401
    LensMap, build_lensmap, device_builder_warm,
)
