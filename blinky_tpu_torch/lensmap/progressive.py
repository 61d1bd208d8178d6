"""Time-sliced, resumable exact lensmap builds.

The reference never blocks its frame loop on a lensmap: construction is
budgeted at 1/60 s per frame with the scan cursor checkpointed in
``struct _lens_builder`` and resumed next frame, so the user watches pixels
appear (``fisheye.c:306-322, 744-746, 819-826``).  The exact float64 host
build costs 0.5-3 s at 1080p, seconds during which an interactive session
(the viewer) would freeze on a lens switch.

:class:`ProgressiveHostBuild` is that mechanism, transcribed from
:mod:`blinky_tpu.lensmap.progressive`: the inverse grid is computed in row
blocks (``inverse_grid(row_range=...)``: every per-pixel quantity is
elementwise in absolute coordinates, so blocks are bit-identical to the same
rows of a one-shot build), the cursor lives here, and ``step(budget_s)``
adapts the block size to the measured row throughput.  ``partial()`` exposes
the in-progress table (unbuilt rows invalid, so they show the background).
It runs on the host in NumPy float64 and touches no device.

Forward-only lenses rasterize in one host pass
(:mod:`blinky_tpu_torch.lensmap.forward_raster`) and are not chunked.
"""

from __future__ import annotations

import time

import numpy as np

from blinky_tpu_torch.lensmap.builder import LensMap, inverse_grid
from blinky_tpu_torch.palette import MAX_PLATES


class ProgressiveHostBuild:
    """Resumable exact (float64 NumPy) inverse lensmap build.

    ``step(budget_s)`` computes row blocks until the budget is spent or the
    build finishes; ``done`` / ``progress`` report the cursor, and
    ``result()`` returns a :class:`LensMap` bit-identical to
    ``build_lensmap(..., backend="numpy")``.
    """

    #: first block: small enough to return promptly even for the slowest
    #: lenses, then adapted from the measured throughput
    INITIAL_ROWS = 16

    def __init__(self, lens, globe, scale, width_px, height_px, platesize,
                 numcells=10, cell_size=4.0, pad_size=1.0, view_basis=None):
        if lens.map_type != "inverse":
            raise ValueError("progressive builds support inverse lenses "
                             "(forward lenses rasterize in one host pass)")
        self.lens, self.globe = lens, globe
        self.scale = float(scale)
        self.width_px, self.height_px = int(width_px), int(height_px)
        self.platesize = int(platesize)
        self.numcells, self.cell_size, self.pad_size = numcells, cell_size, pad_size
        self.view_basis = (None if view_basis is None else tuple(
            np.asarray(v, dtype=np.float64) for v in view_basis))
        H, W = self.height_px, self.width_px
        self._out = dict(
            plate=np.full((H, W), -1, np.int32),
            px=np.zeros((H, W), np.int32),
            py=np.zeros((H, W), np.int32),
            valid=np.zeros((H, W), bool),
            tint=np.full((H, W), MAX_PLATES, np.uint8),
            flat_idx=np.zeros((H, W), np.int32),
            plates_used=np.zeros(MAX_PLATES, bool),
        )
        self._row = 0  # the resumable cursor (lens_builder.inverse_row)
        self._rows_per_s = None

    @property
    def done(self) -> bool:
        return self._row >= self.height_px

    @property
    def progress(self) -> float:
        """Fraction of rows built, 0..1."""
        return self._row / self.height_px if self.height_px else 1.0

    def _block(self, r0: int, r1: int) -> None:
        out = inverse_grid(
            self.lens, self.globe, np.float64(self.scale),
            self.width_px, self.height_px, self.platesize,
            self.numcells, self.cell_size, self.pad_size,
            view_basis=self.view_basis, row_range=(r0, r1),
        )
        for k in ("plate", "px", "py", "valid", "tint", "flat_idx"):
            self._out[k][r0:r1] = out[k]
        self._out["plates_used"] |= np.asarray(out["plates_used"])

    def step(self, budget_s: float = 1 / 60) -> bool:
        """Advance the build for roughly *budget_s* seconds (the reference's
        per-frame slice, ``fisheye.c:645,819-826``).  Returns ``done``."""
        t0 = time.monotonic()
        while not self.done:
            if self._rows_per_s is None:
                nrows = self.INITIAL_ROWS
            else:
                remaining = budget_s - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                nrows = int(min(self.height_px - self._row,
                                max(1, remaining * self._rows_per_s)))
            r0 = self._row
            r1 = min(self.height_px, r0 + nrows)
            tb = time.monotonic()
            self._block(r0, r1)
            dt = max(time.monotonic() - tb, 1e-6)
            rate = (r1 - r0) / dt
            self._rows_per_s = (rate if self._rows_per_s is None
                                else 0.5 * (self._rows_per_s + rate))
            self._row = r1
            if time.monotonic() - t0 >= budget_s:
                break
        return self.done

    def run(self) -> LensMap:
        """Finish the whole build (blocking) and return the result."""
        while not self.done:
            self.step(budget_s=float("inf"))
        return self.result()

    def _lensmap(self, copy: bool) -> LensMap:
        return LensMap(
            width_px=self.width_px, height_px=self.height_px,
            platesize=self.platesize, numplates=self.globe.numplates,
            scale=self.scale, **{k: (v.copy() if copy else v)
                                 for k, v in self._out.items()},
        )

    def result(self) -> LensMap:
        if not self.done:
            raise ValueError("build not finished; use partial() or step()")
        return self._lensmap(copy=False)  # no further mutation

    def partial(self) -> LensMap:
        """A snapshot of the in-progress table (copied: later steps keep
        mutating the working arrays): rows past the cursor are invalid, so a
        render through it shows the background there, the reference's
        pixels-appearing build (``resume_lensmap_inverse``)."""
        return self._lensmap(copy=True)
