"""Debug lens: shows every globe plate in a labeled grid.

Reference: ``game/lua-scripts/lenses/debug.lua`` — the layout depends on
``numplates`` at load time (which is why the reference re-executes the lens
script on globe change, ``fisheye.c:734-737``), and the inverse goes
through the host-provided ``plate_to_ray``.
"""

import numpy as np
import torch

from blinky_tpu_torch import xmath as m


def _layout(numplates):
    if numplates == 4:
        return 2, [2, 2]
    if numplates == 5:
        return 2, [3, 2]
    if numplates == 6:
        return 2, [3, 3]
    return 1, [numplates]


def make(ctx):
    if ctx is None:
        raise ValueError("the debug lens requires a globe context (numplates)")
    rows, cols = _layout(ctx.numplates)
    maxcols = max(cols)
    cols_arr = np.array(cols, dtype=np.int64)
    # plate offset of each row: plate = col + sum(cols[:row])  (debug.lua:50-56)
    row_offset = np.concatenate([[0], np.cumsum(cols_arr)[:-1]])

    def lens_inverse(x, y):
        if m.xp(x, y) is np:
            clip, to_int32, table = np.clip, (lambda a: a.astype(np.int32)), (lambda a: a)
        else:
            # on tensors: torch.clamp, C's truncating cast, the layout tables
            # on the rays' device
            dev = next(t for t in (x, y) if isinstance(t, torch.Tensor)).device
            clip, to_int32 = torch.clamp, (lambda a: a.to(torch.int32))
            table = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        ny = -y + rows / 2
        r, v = m.modf(ny)
        row_ok = ~((ny < 0) | (ny >= rows))
        r_idx = clip(to_int32(r), 0, rows - 1)

        rowcols = table(cols_arr)[r_idx]
        nx = x + rowcols / 2
        c, u = m.modf(nx)
        col_ok = ~((nx < 0) | (nx >= rowcols))
        c_idx = clip(to_int32(c), 0, maxcols - 1)

        valid = row_ok & col_ok
        plate = c_idx + table(row_offset)[r_idx]
        plate = clip(plate, 0, ctx.numplates - 1)
        vx, vy, vz = ctx.plate_to_ray(plate, u, v)
        return vx, vy, vz, valid

    return dict(
        lens_inverse=lens_inverse,
        lens_width=maxcols,
        lens_height=rows,
        onload="f_contain",
    )
