"""The remap: each screen pixel shows the texel its lensmap entry names,
or the background where the entry is not valid (``render_lensmap``,
``fisheye.c:2400-2425``)."""

from __future__ import annotations

import torch


def gather(rows, flat_idx, valid, background):
    """*rows* [R, L] (texels by row, one lane a column), *flat_idx* and
    *valid* [n] from :func:`benchmark.reference.lensmap.build`,
    *background* a scalar of the rows' dtype -> the screens [n, L]."""
    out = rows.index_select(0, flat_idx.to(rows.device))
    bg = torch.tensor(background, dtype=rows.dtype, device=rows.device)
    return torch.where(valid.to(rows.device)[:, None], out, bg)
