"""Forward-path lensmap rasterizer (host, NumPy float64).

The port of :mod:`blinky_tpu.lensmap.forward_raster`.  For lenses that
define only ``lens_forward`` (10 of the 31 shipped lenses), the reference
walks every plate texel, forward-maps its corner grid to screen coordinates
and scanline-fills the resulting quads, in a fixed order whose
last-writer-wins semantics define the output: ``resume_lensmap_forward``
(``engine/NQ/fisheye.c:2126-2217``), ``uv_to_screen``
(``fisheye.c:2227-2243``), ``draw_quad`` (``fisheye.c:2246-2338``).

This is a serial scatter, so it runs on the host at lens-switch time, as in
the JAX package: the corner transform (the numeric hot part) is vectorized
NumPy float64, and the quad fills go through the native library's
``forward_rasterize_plate`` (:mod:`blinky_tpu_torch.native`), or a Python
loop that replays the same scan order when the library is missing: plates
ascending, texel rows ``py`` descending, ``px`` ascending, scanlines y
ascending, x ascending, with the ``maxdiff = 20`` wrap guard
(``fisheye.c:2271-2274``) and the mid-quad abort on an over-wide scanline
(``fisheye.c:2327-2331``).  The tables bit-equal the JAX package's.
"""

from __future__ import annotations

import numpy as np

from blinky_tpu_torch import geometry, native
from blinky_tpu_torch.lensmap.builder import LensMap, TINT_NONE, rubix_grid_mask
from blinky_tpu_torch.palette import MAX_PLATES

_MAXDIFF = 20  # fisheye.c:2271


def _corner_screen(lens, globe, plate, scale, width_px, height_px, platesize,
                   view_basis=None):
    """Screen coordinates of the (S+1)x(S+1) texel-corner grid of a plate.

    Corner k sits at u = (k - 0.5)/S (``fisheye.c:2149-2184``); screen
    mapping truncates ``x/scale + width_px/2`` toward zero with the C int
    division on ``width_px/2`` (``fisheye.c:2239-2240``).
    """
    S = platesize
    cs = (np.arange(S + 1, dtype=np.float64) - 0.5) / S
    U, V = np.meshgrid(cs, cs, indexing="xy")  # V rows, U cols
    # the corner rays pass through vec3_t float32 (plate_uv_to_ray,
    # fisheye.c:1198-1214) before the double Lua forward math
    rx, ry, rz = geometry.plate_uv_to_ray_c(
        U, V, globe.forward[plate], globe.right[plate], globe.up[plate],
        globe.dist[plate], np, np.float32, np.float64,
    )
    rx, ry, rz = rx.astype(np.float64), ry.astype(np.float64), rz.astype(np.float64)
    if view_basis is not None:
        # recording-frame corner ray -> camera frame (inverse of the
        # inverse-path mix; orthonormal basis, so the transpose)
        fwd_v, rgt_v, up_v = (np.asarray(v, dtype=np.float64) for v in view_basis)
        rx, ry, rz = (
            rx * rgt_v[0] + ry * rgt_v[1] + rz * rgt_v[2],
            rx * up_v[0] + ry * up_v[1] + rz * up_v[2],
            rx * fwd_v[0] + ry * fwd_v[1] + rz * fwd_v[2],
        )
    with np.errstate(all="ignore"):
        px, py, ok = lens.forward(rx, ry, rz)
    ok = np.broadcast_to(np.asarray(ok), U.shape)
    with np.errstate(all="ignore"):
        fx = np.asarray(px, dtype=np.float64) / scale + width_px // 2
        fy = -np.asarray(py, dtype=np.float64) / scale + height_px // 2
        # non-finite screen coordinates (C would cast garbage ints and reject
        # them through the maxdiff guard) are invalid corners directly
        finite = np.isfinite(fx) & np.isfinite(fy) & (np.abs(fx) < 2**30) & (np.abs(fy) < 2**30)
        ok = ok & finite
        lx = np.trunc(np.where(finite, fx, 0.0)).astype(np.int64)
        ly = np.trunc(np.where(finite, fy, 0.0)).astype(np.int64)
    return lx, ly, ok


def _draw_quad(tl, tr, bl, br, events):
    """Transcription of ``draw_quad`` (``fisheye.c:2246-2338``); appends
    (lx, ly) writes to *events* in the reference's emission order."""
    p = (tl, tr, br, bl)  # clockwise, fisheye.c:2250
    x, y = tl
    minx = maxx = x
    miny = maxy = y
    for i in range(1, 4):
        tx_, ty_ = p[i]
        if tx_ < minx:
            minx = tx_
        elif tx_ > maxx:
            maxx = tx_
        if ty_ < miny:
            miny = ty_
        elif ty_ > maxy:
            maxy = ty_

    if abs(minx - maxx) > _MAXDIFF or abs(miny - maxy) > _MAXDIFF:
        return

    if miny == maxy and minx == maxx:  # single pixel
        events.append((x, y))
        return
    if miny == maxy:  # horizontal line
        for tx_ in range(minx, maxx + 1):
            events.append((tx_, miny))
        return
    if minx == maxx:  # vertical line
        for ty_ in range(miny, maxy + 1):
            events.append((x, ty_))
        return

    for yy in range(miny, maxy + 1):
        tx = [minx, maxx]
        txi = 0
        j = 3
        for i in range(4):
            ix, iy = p[i]
            jx, jy = p[j]
            if (iy < yy <= jy) or (jy < yy <= iy):
                dy = jy - iy
                dx = jx - ix
                tx[txi] = int(ix + (yy - iy) / dy * dx)
                txi += 1
                if txi == 2:
                    break
            j = i
        if tx[0] > tx[1]:
            tx[0], tx[1] = tx[1], tx[0]
        if tx[1] - tx[0] > _MAXDIFF:  # mid-quad abort, fisheye.c:2327-2331
            return
        for xx in range(tx[0], tx[1] + 1):
            events.append((xx, yy))


def build_forward(
    lens,
    globe,
    scale: float,
    width_px: int,
    height_px: int,
    platesize: int,
    numcells: int = 10,
    cell_size: float = 4.0,
    pad_size: float = 1.0,
    use_native: bool = True,
    view_basis=None,
) -> LensMap:
    """The lensmap of a forward-mapped *lens*, as NumPy arrays.

    ``use_native=False`` takes the Python loop even when the native library
    is there (both give the same tables).  ``view_basis``: optional
    (forward, right, up) camera basis rotating the view within the recorded
    plates, composed into the corner rays.
    """
    S = platesize
    W, H = width_px, height_px
    plate_a = np.full((H, W), -1, dtype=np.int32)
    px_a = np.zeros((H, W), dtype=np.int32)
    py_a = np.zeros((H, W), dtype=np.int32)
    tint_a = np.full((H, W), TINT_NONE, dtype=np.uint8)
    used = np.zeros(MAX_PLATES, dtype=bool)

    # Tint is written per rasterization event, not derived from the final
    # px/py: set_lensmap_grid (fisheye.c:1955-1958) only WRITES the tint
    # byte for off-grid texels, so an on-grid overwrite keeps the previous
    # pixel's tint.
    PX, PY = np.meshgrid(np.arange(S, dtype=np.float64),
                         np.arange(S, dtype=np.float64), indexing="xy")
    offgrid = ~rubix_grid_mask(PX, PY, S, float(numcells), float(cell_size),
                               float(pad_size))  # [S, S] indexed [py, px]

    # the texel-ownership test uses the texel *corner* ray (u = px/S,
    # v = py/S, fisheye.c:2189-2198) against the plate resolver
    ts = np.arange(S, dtype=np.float64) / S
    TU, TV = np.meshgrid(ts, ts, indexing="xy")

    for plate in range(globe.numplates):
        lx, ly, ok = _corner_screen(lens, globe, plate, scale, W, H, S,
                                    view_basis=view_basis)

        rx, ry, rz = geometry.plate_uv_to_ray_c(
            TU, TV, globe.forward[plate], globe.right[plate],
            globe.up[plate], globe.dist[plate], np, np.float32, np.float64,
        )
        if globe.plate_resolver is not None:
            owner = np.asarray(globe.plate_resolver(
                rx.astype(np.float64), ry.astype(np.float64), rz.astype(np.float64), globe
            ))
        else:
            owner = geometry.ray_to_plate_index_c(rx, ry, rz, globe.forward, np)
        owned = owner == plate  # [S, S] indexed [py, px]

        if use_native:
            wrote = native.forward_rasterize_plate(
                lx, ly, ok, owned, offgrid, plate, plate_a, px_a, py_a, tint_a
            )
            if wrote is not None:  # the native library handled this plate
                used[plate] = used[plate] or wrote
                continue

        for py in range(S - 1, -1, -1):  # fisheye.c:2138 (descending rows)
            row_owned = owned[py]
            if not row_owned.any():
                continue
            for px in range(S):
                if not row_owned[px]:
                    continue
                # corner validity: every shipped forward lens is total;
                # guarded for user lenses
                if not (ok[py, px] and ok[py, px + 1] and ok[py + 1, px] and ok[py + 1, px + 1]):
                    continue
                tl = (int(lx[py, px]), int(ly[py, px]))
                tr = (int(lx[py, px + 1]), int(ly[py, px + 1]))
                bl = (int(lx[py + 1, px]), int(ly[py + 1, px]))
                br = (int(lx[py + 1, px + 1]), int(ly[py + 1, px + 1]))
                events: list = []
                _draw_quad(tl, tr, bl, br, events)
                texel_offgrid = bool(offgrid[py, px])
                for exx, eyy in events:
                    if 0 <= exx < W and 0 <= eyy < H:  # fisheye.c:1966-1973
                        used[plate] = True
                        plate_a[eyy, exx] = plate
                        px_a[eyy, exx] = px
                        py_a[eyy, exx] = py
                        if texel_offgrid:
                            tint_a[eyy, exx] = plate

    valid = plate_a >= 0
    flat_idx = np.where(valid, plate_a * (S * S) + py_a * S + px_a, 0).astype(np.int32)
    return LensMap(
        width_px=W,
        height_px=H,
        platesize=S,
        numplates=globe.numplates,
        scale=float(scale),
        plate=plate_a,
        px=px_a,
        py=py_a,
        valid=valid,
        tint=tint_a,
        flat_idx=flat_idx,
        plates_used=used,
    )
