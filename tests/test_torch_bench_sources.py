"""The bench's synthetic sources (blinky_tpu_torch/bench/throughput.py)
against the jitted JAX generators of blinky_tpu.bench.throughput, on the
CPU, tolerance 0: every layout, u8 and packed RGBA, at S = 48 and batches
that are not a multiple of the generators' lane chunk."""

import jax
import numpy as np
import pytest
import torch

from blinky_tpu.bench import throughput as jt
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.bench import throughput as tt
from blinky_tpu_torch.kernels.remap import compact_planes, compact_rows, compact_texels
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

S = 48
CHUNK = 16


def _np(t):
    """A port source as NumPy: packed RGBA's int32 bits as uint32."""
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _jax(a):
    return np.asarray(jax.device_get(a))


@pytest.fixture(scope="module")
def lensmap():
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    return build_lensmap(lens, g, calc_scale(Zoom("fov", 180), lens, 64, 48), 64, 48, S)


@pytest.mark.parametrize("B", [1, 7, CHUNK + 3, 3 * CHUNK + 1])
@pytest.mark.parametrize("expanded,rgba", [(False, False), (True, False), (False, True),
                                           (True, True)])
def test_device_source_equals_jax(B, expanded, rgba):
    got = tt.device_source(S, B, expanded, rgba, device="cpu", chunk=CHUNK)
    assert got.dtype == (torch.int32 if rgba else torch.uint8)
    np.testing.assert_array_equal(_np(got), _jax(jt.device_source(S, B, expanded, rgba)))


@pytest.mark.parametrize("plane_ids", [(0,), (1, 3, 4), (0, 2, 7, 11), (5, 6, 9)])
@pytest.mark.parametrize("rgba", [False, True])
def test_device_source_plane_subset_equals_jax(plane_ids, rgba):
    got = tt.device_source(S, CHUNK + 5, plane_ids[-1] >= 6, rgba, plane_ids, device="cpu",
                           chunk=CHUNK)
    ref = jt.device_source(S, CHUNK + 5, plane_ids[-1] >= 6, rgba, plane_ids)
    np.testing.assert_array_equal(_np(got), _jax(ref))


@pytest.mark.parametrize("rubix", [False, True])
@pytest.mark.parametrize("rgba", [False, True])
def test_device_source_rows_equals_jax(lensmap, rubix, rgba):
    slabs, _ = compact_rows(lensmap, rubix=rubix)
    B = 2 * CHUNK + 9
    got = tt.device_source_rows(S, B, rgba, slabs, device="cpu", chunk=CHUNK)
    np.testing.assert_array_equal(_np(got), _jax(jt.device_source_rows(S, B, rgba, slabs)))


@pytest.mark.parametrize("rubix", [False, True])
@pytest.mark.parametrize("rgba", [False, True])
def test_device_source_texels_equals_jax(lensmap, rubix, rgba):
    texels, _ = compact_texels(lensmap, rubix=rubix)
    B = CHUNK + 11
    got = tt.device_source_texels(S, B, rgba, texels, device="cpu", chunk=CHUNK)
    np.testing.assert_array_equal(_np(got), _jax(jt.device_source_texels(S, B, rgba, texels)))


def test_device_cubemap_batch_equals_jax():
    np.testing.assert_array_equal(_np(tt.device_cubemap_batch(S, 5, device="cpu")),
                                  _jax(jt.device_cubemap_batch(S, 5)))


def test_compacted_sources_hold_the_full_sources_values(lensmap):
    """Each compacted layout is the full source's referenced part: plane
    subset, row slabs and texels all read the same values there."""
    B = 5
    full = tt.device_source(S, B, True, False, device="cpu")
    flat = full.reshape(-1, B)
    plane_ids, _ = compact_planes(lensmap, rubix=True)
    np.testing.assert_array_equal(
        tt.device_source(S, B, True, False, plane_ids, device="cpu").numpy(),
        full[list(plane_ids)].numpy())
    slabs, _ = compact_rows(lensmap, rubix=True)
    np.testing.assert_array_equal(
        tt.device_source_rows(S, B, False, slabs, device="cpu").numpy(),
        torch.cat([full[p, lo:hi] for p, lo, hi in slabs]).numpy())
    texels, _ = compact_texels(lensmap, rubix=True)
    np.testing.assert_array_equal(
        tt.device_source_texels(S, B, False, texels, device="cpu").numpy(),
        flat[torch.from_numpy(texels)].numpy())


def test_chunk_does_not_change_the_values():
    ref = tt.device_source(S, 37, False, True, device="cpu", chunk=128)
    for chunk in (1, 5, 36, 37):
        assert torch.equal(tt.device_source(S, 37, False, True, device="cpu", chunk=chunk), ref)
