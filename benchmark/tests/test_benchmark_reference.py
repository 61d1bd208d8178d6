"""The reference against the program's exact paths at small sizes on the
CPU.  The tests may import the program; the reference may not."""

import numpy as np
import pytest
import torch

from benchmark.drivers import equirect_card
from benchmark.reference import equirect as ref_equirect
from benchmark.reference import lensmap as ref_lensmap
from benchmark.reference import remap as ref_remap
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.kernels.ingest import _build_tables, equirect_gather_plain
from blinky_tpu_torch.kernels.remap import frames_to_rgba, remap_gather_plain
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.palette import default_palette

CUBE = globes.get("cube")
PANINI = lenses.get("panini", CUBE)


@pytest.mark.parametrize("fov", [100, 180, 250, 330])
@pytest.mark.parametrize("width", [64, 96, 1920])
def test_fov_scale_equals_the_zoom_solve(fov, width):
    assert ref_lensmap.fov_scale("panini", fov, width) == calc_scale(
        Zoom("fov", fov), PANINI, width, width * 9 // 16)


@pytest.mark.parametrize("fov,size", [(180, (96, 72, 72)), (100, (96, 72, 72)),
                                      (330, (64, 48, 48)), (180, (160, 90, 90)),
                                      (250, (128, 96, 96)), (180, (320, 180, 180))])
def test_lensmap_equals_the_exact_host_build(fov, size):
    W, H, S = size
    lm = build_lensmap(PANINI, CUBE, calc_scale(Zoom("fov", fov), PANINI, W, H), W, H, S)
    flat, valid = ref_lensmap.build("panini", "cube", fov, W, H, S)
    np.testing.assert_array_equal(valid.numpy(), lm.valid.reshape(-1))
    np.testing.assert_array_equal(flat.numpy(), np.where(lm.valid, lm.flat_idx, 0).reshape(-1))


def test_one_precision_down_differs():
    """The control's lensmap is not the reference's: the float32 one differs
    at texel edges."""
    flat, _ = ref_lensmap.build("panini", "cube", 180, 96, 72, 72)
    f32, _ = ref_lensmap.build("panini", "cube", 180, 96, 72, 72, hi=torch.float32)
    assert (flat != f32).any()


@pytest.mark.parametrize("pano,S", [((64, 128), 48), ((30, 64), 16), ((2048, 4096), 8)])
def test_equirect_taps_equal_the_ingest_tables(pano, S):
    H, W = pano
    idx, w = _build_tables(H, W, S, CUBE, True)
    rows, wt, on = ref_equirect.taps("cube", S, H, W, torch.arange(6 * S * S))
    np.testing.assert_array_equal(rows.numpy(), idx)
    np.testing.assert_array_equal(wt.numpy(), w)
    assert bool(on.all())


def test_blend_equals_the_ingests_plain_version():
    g = torch.Generator().manual_seed(3)
    src = torch.randint(-2**31, 2**31 - 1, (50, 5), generator=g, dtype=torch.int64).to(torch.int32)
    idx = torch.randint(0, 50, (4, 40), generator=g, dtype=torch.int64)
    w = torch.rand((4, 40), generator=g)
    want = equirect_gather_plain(src, idx.to(torch.int32), w)
    assert torch.equal(ref_equirect.blend(src[idx], w), want)


def test_background_is_palette_colour_0():
    bg = frames_to_rgba(np.zeros(1, np.uint8), default_palette()).view(np.int32)[0]
    assert equirect_card.BACKGROUND == bg


def test_gather_equals_the_remap_kernels_plain_version():
    g = torch.Generator().manual_seed(4)
    flat, valid = ref_lensmap.build("panini", "cube", 180, 64, 48, 48)
    src = torch.randint(0, 256, (6 * 48 * 48, 3), generator=g, dtype=torch.uint8)
    bg = torch.zeros(flat.numel(), dtype=torch.uint8)
    want = remap_gather_plain(src, flat.to(torch.int32), valid, bg, fill=True)
    assert torch.equal(ref_remap.gather(src, flat, valid, 0), want)
