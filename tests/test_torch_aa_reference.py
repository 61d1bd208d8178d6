"""``Session.render_aa`` against the benchmark's plain reference of the
supersampled path (``benchmark/reference/aa.py``), on the CPU, where the
session runs K1's and K11's plain versions.

The sizes are the benchmark's CPU sizes (a 64x48 screen, 48-pixel plates,
B = 4), the frames and the palette the cell's own of a seed
(``benchmark/sources.py``, ``benchmark/drivers/aa_card.py::palette``).
Panini on the cube at factors 2 and 3 runs the reference whole, its
lensmap from the lens and globe equations.  The reference has no fisheye1
lens (its lensmap module writes panini alone), so the fisheye1 case under
``f_contain``, whose circle leaves the screen's sides to a background
image, gives it the program's exact host lensmap at the supersampled size:
there it holds the decode, the gather with the repeated background and
the box filter.  Every case reads 0: no screen pixel differs.  Four planted
faults must read above 0.
"""

import numpy as np
import pytest
import torch

from benchmark import compare, harness, program, sources
from benchmark.drivers import aa_card
from benchmark.reference import aa as ref_aa
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.kernels import remap
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

CELL = "pc1080.render_aa"
_, CFG, _ = harness.resolve(harness.benchmark_spec(), CELL)
CFG = {**CFG, "width": 64, "height": 48, "platesize": 48}
B, SEED = 4, 2**31 + 31


@pytest.fixture(scope="module")
def frames():
    return sources.cubemap_batches(CFG["platesize"], B, 1, SEED, "cpu")[0]


@pytest.fixture(scope="module")
def palette():
    return aa_card.palette(SEED)


def _session(pal, cfg=CFG):
    sess = program.session(cfg, "cpu")
    sess.palette = pal
    return sess


def _mismatch(out, expect):
    """The largest share of a lane's screen pixels that differ."""
    return compare.worst_lane_mismatch(out.view(torch.int32).reshape(-1, out.shape[-1]),
                                       expect.reshape(-1, expect.shape[-1]))


@pytest.mark.parametrize("factor", [2, 3])
def test_panini_equals_the_reference(frames, palette, factor):
    cfg = {**CFG, "factor": factor}
    out = _session(palette, cfg).render_aa(frames, factor=factor)
    expect = ref_aa.AA(cfg, palette)(frames)
    assert out.dtype == torch.uint32 and tuple(out.shape) == (48, 64, B)
    assert _mismatch(out, expect) == 0.0
    assert torch.equal(out.view(torch.int32), expect)


def test_fisheye1_contain_with_a_background_equals_the_reference(frames, palette):
    W, H, S, k = 64, 48, 48, 2
    sess = Session(W, H, platesize=S, device="cpu")
    sess.palette = palette
    for line in ("fisheye 1", "f_globe cube", "f_lens fisheye1", "f_contain"):
        sess.cmd(line)
    bg = np.random.default_rng(5).integers(0, 256, (H, W), dtype=np.uint8)
    sess.set_background(bg)
    out = sess.render_aa(frames, factor=k)
    cube = globes.get("cube")
    lens = lenses.get("fisheye1", cube)
    lm = build_lensmap(lens, cube, calc_scale(Zoom("contain"), lens, k * W, k * H),
                       k * W, k * H, S)
    valid = torch.from_numpy(np.ascontiguousarray(lm.valid).reshape(-1))
    flat = torch.from_numpy(np.where(lm.valid, lm.flat_idx, 0).reshape(-1)).to(torch.int64)
    assert 0 < int(valid.sum()) < valid.numel()  # the lens leaves gaps to the background
    expect = ref_aa.screens(frames, ref_aa.rgba_table(palette), flat, valid, W, H, k,
                            background=bg)
    assert _mismatch(out, expect) == 0.0
    # the background shows: a corner pixel is the background's colour
    corner = int(ref_aa.rgba_table(palette)[int(bg[0, 0])])
    assert (out.view(torch.int32)[0, 0] == corner).all()


def _factor_one(sess, frames, monkeypatch):
    return sess.render_aa(frames, factor=1)


def _no_half(sess, frames, monkeypatch):
    """The box filter truncates its mean, without the + 0.5."""
    def truncating(hi, factor, **kw):
        k = int(factor)
        hi = hi.view(torch.int32)
        H, W = hi.shape[0] // k, hi.shape[1] // k
        count = torch.tensor(float(k * k))
        out = torch.full((H, W) + tuple(hi.shape[2:]), -(1 << 24), dtype=torch.int32)
        for shift in (0, 8, 16):
            c = ((hi >> shift) & 0xFF).reshape((H, k, W, k) + tuple(hi.shape[2:])).sum(dim=(1, 3))
            out |= (c.to(torch.float32) / count).clamp(0, 255).to(torch.int32) << shift
        return out.view(torch.uint32)

    monkeypatch.setattr(remap, "downsample_rgba", truncating)
    return sess.render_aa(frames, factor=2)


def _shifted_lane(sess, frames, monkeypatch):
    out = sess.render_aa(frames, factor=2).view(torch.int32).clone()
    out[..., 1] = torch.roll(out[..., 1], 1, dims=0)
    return out


def _swapped_channels(sess, frames, monkeypatch):
    sess.palette = np.ascontiguousarray(sess.palette[:, ::-1])
    return sess.render_aa(frames, factor=2)


@pytest.mark.parametrize("fault", [_factor_one, _no_half, _shifted_lane, _swapped_channels])
def test_a_fault_reads_above_zero(frames, palette, monkeypatch, fault):
    expect = ref_aa.AA({**CFG, "factor": 2}, palette)(frames)
    out = fault(_session(palette), frames, monkeypatch)
    assert _mismatch(out, expect) > 0.0


def test_decode_table_follows_the_packing_rule(palette):
    table = ref_aa.rgba_table(palette)
    assert table.dtype == torch.int32 and table.shape == (256,)
    words = table.numpy().view(np.uint32)
    for i in (0, 1, 128, 255):
        r, g, b = (int(x) for x in palette[i])
        assert int(words[i]) == r + 256 * g + 65536 * b + 0xFF000000


def test_box_rounds_half_up_in_float32():
    """Sums whose mean ends in .5 round up; 9 samples divide truly."""
    hi = torch.zeros((3, 3, 2), dtype=torch.int32)
    hi[0, 0, 0] = 1  # mean 1/9: 0
    hi[..., 1] = 5  # red 5 over 9 samples: 5
    hi[:2, :2, 1] |= 1 << 8  # green 4/9 + 0.5: 0
    out = ref_aa.box(hi, 3).view(torch.uint32)
    assert out.shape == (1, 1, 2)
    word = out.view(torch.int32).numpy().view(np.uint32).reshape(-1)
    assert int(word[0]) == 0xFF000000 and int(word[1]) == 0xFF000005
    two = torch.tensor([[[1], [2]], [[0], [0]]], dtype=torch.int32)  # mean 0.75: 1
    assert int(ref_aa.box(two, 2).view(torch.int32).numpy().view(np.uint32)[0, 0, 0]) \
        == 0xFF000001
