"""The port's remap (blinky_tpu_torch.kernels.remap) against blinky_tpu's.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
those, RemapKernel and host_remap to the JAX package's functions on the same
inputs (made from a numpy seed) with tolerance 0: every output is an
integer.  The out-of-range rules (clip for the gathers, fill for remap_impl)
and the background rules are pinned here.  The kernels themselves run only
on a card: tests/test_torch_cuda.py compares them with these plain versions
there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.bench import throughput as jthroughput
from blinky_tpu.kernels import remap as jremap
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.palette import default_palette, tint_lut
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.bench.throughput import device_source_texels
from blinky_tpu_torch.kernels import remap
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

W, H, S = 64, 48, 48
R_PLAIN = 6 * S * S


def _lensmaps(variant):
    """(JAX lensmap, port lensmap) for panini + cube at f_fov 180.  The
    "holes" variant punches invalid pixels and out-of-range indices (both
    signs, both within and beyond one wrap) into both alike."""
    jg = jglobes.get("cube")
    jl = jlenses.get("panini", jg)
    jlm = jbuild(jl, jg, jcalc(JZoom("fov", 180), jl, W, H), W, H, S,
                 backend="numpy").to_numpy()
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom("fov", 180), lens, W, H), W, H, S)
    if variant == "holes":
        rng = np.random.default_rng(7)
        valid = lm.valid & (rng.random((H, W)) > 0.2)
        fi = lm.flat_idx.copy()
        pick = rng.random((H, W)) < 0.15
        bad = np.array([-1, -7, -R_PLAIN, -R_PLAIN - 1, -2 * R_PLAIN - 5,
                        R_PLAIN, R_PLAIN + 3, 2 * R_PLAIN + 1, 3 * R_PLAIN],
                       np.int32)
        fi[pick] = rng.choice(bad, pick.sum())
        jlm = dataclasses.replace(jlm, valid=valid, flat_idx=fi)
        lm = dataclasses.replace(lm, valid=valid.copy(), flat_idx=fi.copy())
    return jlm, lm


@pytest.fixture(scope="module")
def pal():
    return default_palette()


def _frames(B, seed=0, plates=6, size=S):
    rng = np.random.default_rng(seed)
    shape = (plates, size, size) + ((B,) if B else ())
    return rng.integers(0, 256, shape, dtype=np.uint8)


# source kind -> (JAX source maker, port source maker, call kwargs)
KINDS = {
    "u8": (lambda f, p: f, lambda f, p: f, {}),
    "u8_rubix": (lambda f, p: f, lambda f, p: f, dict(rubix=True)),
    "u8_decode": (lambda f, p: f, lambda f, p: f, dict(decode_rgb=True)),
    "u8_rubix_decode": (lambda f, p: f, lambda f, p: f,
                        dict(rubix=True, decode_rgb=True)),
    "expanded_rubix": (jremap.expand_frames_tinted, remap.expand_frames_tinted,
                       dict(rubix=True)),
    "expanded_raw": (jremap.expand_frames_tinted, remap.expand_frames_tinted, {}),
    "expanded_decode": (jremap.expand_frames_tinted, remap.expand_frames_tinted,
                        dict(rubix=True, decode_rgb=True)),
    "rgba": (jremap.frames_to_rgba, remap.frames_to_rgba, {}),
    "rgba_tint": (jremap.frames_to_rgba, remap.frames_to_rgba, dict(rubix=True)),
    "rgba_expanded": (
        lambda f, p: jremap.expand_frames_tinted_rgba(jremap.frames_to_rgba(f, p)),
        lambda f, p: remap.expand_frames_tinted_rgba(remap.frames_to_rgba(f, p)),
        dict(rubix=True)),
}


@pytest.mark.parametrize("variant", ["base", "holes"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_remap_kernel_bit_equals_jax(kind, variant, pal):
    jmake, make, kw = KINDS[kind]
    jlm, lm = _lensmaps(variant)
    frames = _frames(5, seed=1)
    bg = np.random.default_rng(2).integers(0, 256, (H, W), dtype=np.uint8)
    expect = np.asarray(jremap.RemapKernel(jlm, pal, bg)(jmake(frames, pal), **kw))
    src = make(frames, pal)
    np.testing.assert_array_equal(src, jmake(frames, pal))
    out = remap.RemapKernel(lm, pal, bg, device="cpu")(src, **kw)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    got = np.asarray(out)
    assert got.dtype == expect.dtype and got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("kind,B,plates,size", [
    ("u8", 130, 6, S),               # wide batch
    ("u8_decode", 0, 6, S),          # one [P, S, S] frame
    ("rgba_tint", 0, 6, S),
    ("u8_rubix", 3, 4, S),           # fewer planes: zero-padded to 6
    ("u8", 4, 6, 32),                # smaller plates: indices past the end (fill)
    ("expanded_rubix", 4, 6, 32),    # ... and under the clip rule
    ("rgba", 4, 6, 32),
])
def test_remap_kernel_shapes(kind, B, plates, size, pal):
    jmake, make, kw = KINDS[kind]
    jlm, lm = _lensmaps("base")
    frames = _frames(B, seed=3, plates=plates, size=size)
    expect = np.asarray(jremap.RemapKernel(jlm, pal)(jmake(frames, pal), **kw))
    got = np.asarray(remap.RemapKernel(lm, pal, device="cpu")(make(frames, pal), **kw))
    assert got.shape == expect.shape
    np.testing.assert_array_equal(got, expect)


def test_remap_kernel_tensor_and_int_inputs(pal):
    """Tensors pass in as they are (torch.uint32 for RGBA), and non-u8
    palette indices are normalized to u8, as jnp's astype does."""
    jlm, lm = _lensmaps("base")
    frames = _frames(3, seed=4)
    k = remap.RemapKernel(lm, pal, device="cpu")
    a = np.asarray(k(frames))
    np.testing.assert_array_equal(np.asarray(k(torch.from_numpy(frames))), a)
    wide = frames.astype(np.int64) + 512
    np.testing.assert_array_equal(np.asarray(k(wide)), a)
    np.testing.assert_array_equal(np.asarray(k(torch.from_numpy(wide))), a)
    rgba = remap.frames_to_rgba(frames, pal)
    np.testing.assert_array_equal(np.asarray(k(torch.from_numpy(rgba))),
                                  np.asarray(jremap.RemapKernel(jlm, pal)(rgba)))


def test_background_rules(pal):
    """A u32 background under u32 frames is used as it is, a u8 one is
    decoded through the palette, and under u8 frames a u32 one raises."""
    jlm, lm = _lensmaps("holes")
    frames = _frames(2, seed=5)
    rgba = remap.frames_to_rgba(frames, pal)
    rng = np.random.default_rng(6)
    bg8 = rng.integers(0, 256, (H, W), dtype=np.uint8)
    bg32 = rng.integers(0, 2**32, (H, W), dtype=np.uint32)
    for bg in (bg8, bg32):
        expect = np.asarray(jremap.RemapKernel(jlm, pal, bg)(rgba))
        got = np.asarray(remap.RemapKernel(lm, pal, bg, device="cpu")(rgba))
        np.testing.assert_array_equal(got, expect)
    with pytest.raises(ValueError, match="u8 frames need a u8"):
        jremap.RemapKernel(jlm, pal, bg32)(frames)
    with pytest.raises(ValueError, match="u8 frames need a u8"):
        remap.RemapKernel(lm, pal, bg32, device="cpu")(frames)
    with pytest.raises(ValueError, match="needs a palette"):
        remap.RemapKernel(lm, device="cpu")(frames, rubix=True)
    with pytest.raises(ValueError, match="needs a palette"):
        remap.RemapKernel(lm, device="cpu")(rgba)


# ------------------------------------------------- the kernels' semantics


def _rand_case(B, dtype, seed):
    rng = np.random.default_rng(seed)
    P_, S_ = 6, 4
    R = P_ * S_ * S_
    n = 7 * 9
    hi = 2**32 if dtype == np.uint32 else 256
    src = rng.integers(0, hi, (P_, S_, S_, B), dtype=dtype)
    idx = rng.integers(-2 * R - 3, 2 * R + 3, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    bg = rng.integers(0, hi, n, dtype=dtype)
    return src, idx, valid, bg


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint32])
@pytest.mark.parametrize("B", [1, 5, 16])
def test_remap_gather_clip_rule_vs_jax(dtype, B):
    src, idx, valid, bg = _rand_case(B, dtype, seed=B)
    expect = np.asarray(jremap.remap_gather_impl(
        jnp.asarray(src), jnp.asarray(idx.reshape(7, 9)),
        jnp.asarray(valid.reshape(7, 9)), jnp.asarray(bg.reshape(7, 9))))
    got = remap.remap_gather(_t(src.reshape(-1, B)), _t(idx), _t(valid), _t(bg))
    np.testing.assert_array_equal(got.numpy().view(dtype), expect.reshape(-1, B))


@pytest.mark.parametrize("B", [1, 5, 16])
def test_remap_gather_fill_rule_vs_jax(B):
    """remap_impl without tables: jnp.take's default wraps [-R, 0) once and
    fills everything else out of range with 255."""
    src, idx, valid, bg = _rand_case(B, np.uint8, seed=10 + B)
    dummy = jnp.zeros((1,), jnp.uint8)
    expect = np.asarray(jremap.remap_impl(
        jnp.asarray(src), jnp.asarray(idx.reshape(7, 9)),
        jnp.asarray(valid.reshape(7, 9)), jnp.zeros((7, 9), jnp.uint8),
        jnp.asarray(bg.reshape(7, 9)), dummy, dummy, rubix=False,
        decode_rgb=False))
    got = remap.remap_gather(_t(src.reshape(-1, B)), _t(idx), _t(valid), _t(bg),
                             fill=True)
    np.testing.assert_array_equal(got.numpy(), expect.reshape(-1, B))


@pytest.mark.parametrize("B", [1, 4, 7])
def test_remap_gather_tint_vs_jax(B):
    src, idx, valid, bg = _rand_case(B, np.uint32, seed=20 + B)
    rng = np.random.default_rng(30 + B)
    tr = rng.integers(0, 2**32, idx.size, dtype=np.uint32)
    tm = (rng.random(idx.size) < 0.6) & valid
    expect = np.asarray(jremap.remap_gather_tint_impl(
        jnp.asarray(src), jnp.asarray(idx.reshape(7, 9)),
        jnp.asarray(valid.reshape(7, 9)), jnp.asarray(bg.reshape(7, 9)),
        jnp.asarray(tr.reshape(7, 9)), jnp.asarray(tm.reshape(7, 9))))
    got = remap.remap_gather(_t(src.reshape(-1, B)), _t(idx), _t(valid), _t(bg),
                             tint_rgb=_t(tr), tint_mask=_t(tm))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), expect.reshape(-1, B))


@pytest.mark.parametrize("rubix,decode", [(True, False), (False, True), (True, True)])
@pytest.mark.parametrize("B", [1, 6, 16, 64])
def test_remap_lut_vs_jax(rubix, decode, B, pal):
    """remap_impl: fill rule, the tint LUT filling 255 past its 1,792
    entries (tint values up to 255 here), background, RGB decode.  B = 16
    and 64 are the widths that take K2's 16-texel vectors on a card."""
    src, idx, valid, bg = _rand_case(B, np.uint8, seed=40 + B)
    tint = np.random.default_rng(50 + B).integers(0, 256, idx.size, dtype=np.uint8)
    tl = tint_lut(pal)
    expect = np.asarray(jremap.remap_impl(
        jnp.asarray(src), jnp.asarray(idx.reshape(7, 9)),
        jnp.asarray(valid.reshape(7, 9)), jnp.asarray(tint.reshape(7, 9)),
        jnp.asarray(bg.reshape(7, 9)), jnp.asarray(tl), jnp.asarray(pal),
        rubix=rubix, decode_rgb=decode))
    got = remap.remap_lut(_t(src.reshape(-1, B)), _t(idx), _t(valid), _t(tint),
                          _t(bg), _t(tl) if rubix else None,
                          _t(pal) if decode else None)
    np.testing.assert_array_equal(got.numpy(), expect.reshape(got.shape))


@pytest.mark.parametrize("B", [5, 16])
def test_remap_lut_clip_decode_vs_jax(B, pal):
    """The decode after an expanded gather: clip rule, then rgb_lut."""
    src, idx, valid, bg = _rand_case(B, np.uint8, seed=55 + B)
    g = jremap.remap_gather_impl(
        jnp.asarray(src), jnp.asarray(idx.reshape(7, 9)),
        jnp.asarray(valid.reshape(7, 9)), jnp.asarray(bg.reshape(7, 9)))
    expect = np.asarray(jnp.take(jnp.asarray(pal), g.astype(jnp.int32), axis=0))
    got = remap.remap_lut(_t(src.reshape(-1, B)), _t(idx), _t(valid),
                          torch.zeros(idx.size, dtype=torch.uint8), _t(bg),
                          rgb_lut=_t(pal), fill=False)
    np.testing.assert_array_equal(got.numpy(), expect.reshape(got.shape))


def test_wrappers_check_operands_and_devices(pal):
    src, idx, valid, bg = (_t(a) for a in _rand_case(4, np.uint8, seed=70))
    src = src.reshape(-1, 4)
    with pytest.raises(ValueError, match="idx"):
        remap.remap_gather(src, idx.long(), valid, bg)
    with pytest.raises(ValueError, match="src"):
        remap.remap_gather(src.t(), idx, valid, bg)
    with pytest.raises(ValueError, match="bg"):
        remap.remap_gather(src, idx, valid, bg.int())
    with pytest.raises(ValueError, match="tint"):
        remap.remap_gather(src, idx, valid, bg, tint_rgb=idx, tint_mask=valid)
    with pytest.raises(ValueError, match="tint_lut or an rgb_lut"):
        remap.remap_lut(src, idx, valid, bg, bg)
    with pytest.raises(ValueError, match="rgb_lut"):
        remap.remap_lut(src, idx, valid, bg, bg, rgb_lut=_t(pal[:200]))
    # no silent path for a device that has neither kernel nor plain version
    meta = [t.to("meta") for t in (src, idx, valid, bg)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        remap.remap_gather(*meta)
    assert remap.remap_gather.launches == 0 and remap.remap_lut.launches == 0



_RING_MIN = remap.RING_MIN_ROW_BYTES


@pytest.mark.parametrize("row_bytes,src_off,out_off,ring", [
    (_RING_MIN, 0, 0, True),
    (_RING_MIN - 16, 0, 0, False),        # under the threshold: the register path
    (_RING_MIN + 16, 0, 0, True),
    (1024, 0, 0, True),                   # the batch cell's rows, u8 B = 1024
    (512, 0, 0, True),                    # the 360 cell's rows, u32 B = 128
    (256, 0, 0, True),                    # render_aa's rows, u32 B = 64
    (64, 0, 0, False),                    # u8 B = 64
    (21760, 0, 0, True),                  # the headline's rows
    (70000, 0, 0, True),                  # longer than a stage: in pieces
    (1024 + 4, 0, 0, False),              # no multiple of 16 bytes
    (1024, 1, 0, False), (1024, 4, 0, False), (1024, 8, 0, False),   # src off 16
    (1024, 0, 4, False), (1024, 0, 8, False),                        # out off 16
    (1024, 16, 32, True),
])
def test_ring_path_decides_on_row_bytes_and_alignment(row_bytes, src_off, out_off, ring):
    base = 1 << 40
    assert remap.ring_path(row_bytes, base + src_off, base + out_off) is ring


@pytest.mark.parametrize("dtype,B", [(torch.uint8, 1024), (torch.int32, 128),
                                     (torch.uint8, 64)])
def test_remap_gather_on_the_cpu_runs_the_plain_version(dtype, B):
    """On the CPU neither counter moves, whatever the row, and the wrapper
    returns the plain version's screen."""
    rng = np.random.default_rng(B)
    R, n = 50, 333
    if dtype == torch.uint8:
        src = rng.integers(0, 256, (R, B), dtype=np.uint8)
        bg = rng.integers(0, 256, n, dtype=np.uint8)
    else:
        src = rng.integers(-2**31, 2**31, (R, B), dtype=np.int64).astype(np.int32)
        bg = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    src, bg = torch.from_numpy(src), torch.from_numpy(bg)
    idx = torch.from_numpy(rng.integers(-2 * R, 2 * R, n).astype(np.int32))
    valid = torch.from_numpy(rng.random(n) < 0.8)
    n0, b0 = remap.remap_gather.launches, remap.remap_gather.bulk_launches
    for fill in (False, True):
        got = remap.remap_gather(src, idx, valid, bg, fill=fill)
        assert torch.equal(got, remap.remap_gather_plain(src, idx, valid, bg, fill=fill))
    assert (remap.remap_gather.launches, remap.remap_gather.bulk_launches) == (n0, b0)

# --------------------------------------------------------- host functions


@pytest.mark.parametrize("variant", ["base", "holes"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_host_remap_bit_equals_jax(kind, variant, pal):
    jmake, make, kw = KINDS[kind]
    jlm, lm = _lensmaps(variant)
    frame = _frames(0, seed=8)
    bg = np.random.default_rng(9).integers(0, 256, (H, W), dtype=np.uint8)
    expect = jremap.host_remap(jlm, jmake(frame, pal), pal, bg, **kw)
    got = remap.host_remap(lm, make(frame, pal), pal, bg, **kw)
    assert got.dtype == expect.dtype
    np.testing.assert_array_equal(got, expect)
    # and the host path agrees with the remap kernel's plain versions
    dev = np.asarray(remap.RemapKernel(lm, pal, bg, device="cpu")(make(frame, pal), **kw))
    if variant == "base" or kind not in ("u8", "u8_rubix", "u8_decode",
                                         "u8_rubix_decode"):
        np.testing.assert_array_equal(dev, got)  # (u8 holes: fill vs clip)


def test_host_helpers_equal_jax(pal):
    jlm, lm = _lensmaps("base")
    frames = _frames(3, seed=11)
    np.testing.assert_array_equal(remap.expanded_flat_idx(lm),
                                  jremap.expanded_flat_idx(jlm))
    for rubix in (False, True):
        for fn in ("compact_planes", "compact_rows", "compact_texels"):
            a, b = getattr(remap, fn)(lm, rubix), getattr(jremap, fn)(jlm, rubix)
            assert np.asarray(a[0]).tolist() == np.asarray(b[0]).tolist(), fn
            np.testing.assert_array_equal(a[1], b[1], err_msg=fn)
    slabs, _ = remap.compact_rows(lm)
    np.testing.assert_array_equal(remap.crop_frames_rows(frames, slabs),
                                  jremap.crop_frames_rows(frames, slabs))
    texels, _ = remap.compact_texels(lm)
    for f in (frames, frames[..., 0]):
        np.testing.assert_array_equal(remap.take_texels(f, texels),
                                      jremap.take_texels(f, texels))
    np.testing.assert_array_equal(remap.expand_frames_tinted(frames[:4], pal),
                                  jremap.expand_frames_tinted(frames[:4], pal))
    rgba = remap.frames_to_rgba(frames, pal)
    np.testing.assert_array_equal(rgba, jremap.frames_to_rgba(frames, pal))
    np.testing.assert_array_equal(remap.expand_frames_tinted_rgba(rgba[:5]),
                                  jremap.expand_frames_tinted_rgba(rgba[:5]))
    rgb = np.random.default_rng(12).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    for x in (rgb, np.concatenate([rgb, rgb[..., :1]], axis=-1)):
        np.testing.assert_array_equal(remap.pack_rgba(x), jremap.pack_rgba(x))
    np.testing.assert_array_equal(remap.unpack_rgb(rgba), jremap.unpack_rgb(rgba))


@pytest.mark.parametrize("rgba", [False, True])
def test_device_source_texels_equals_jax(rgba):
    _, lm = _lensmaps("base")
    texels, _ = remap.compact_texels(lm, rubix=True)
    expect = np.asarray(jthroughput.device_source_texels(S, 37, rgba, texels))
    got = device_source_texels(S, 37, rgba, texels, device="cpu", chunk=16)
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32) if rgba else got.numpy(), expect)


# ------------------------------------------------ K11 and K12's plain versions


def _blocks_with_every_sum(k):
    """[k, n*k] u32 screen whose n = 255*k*k + 1 blocks of k x k hold every
    possible channel sum once (the all-equal blocks at every value and the
    sums k*k*n + k*k/2 that land on the .5 tie among them), the same value
    in R, G and B and a varying alpha that the resolve must overwrite."""
    sums = np.arange(255 * k * k + 1)
    q, r = np.divmod(sums, k * k)
    blocks = q[:, None] + (np.arange(k * k)[None, :] < r[:, None])
    assert (blocks.sum(1) == sums).all() and blocks.max() <= 255
    hi = blocks.reshape(-1, k, k).transpose(1, 0, 2).reshape(k, -1).astype(np.uint32)
    return hi | (hi << 8) | (hi << 16) | ((hi ^ 0x5A) << 24), sums


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6])
def test_downsample_rgba_every_sum_equals_jax(k):
    """Every channel sum a k x k block can have, against _downsample_rgba.
    What this pins: jnp.mean's divide by k*k and a multiply by the float32
    reciprocal give the same byte for every sum at these k (after + 0.5 and
    the truncation), so the kernel's correctly rounded divide equals both."""
    hi, sums = _blocks_with_every_sum(k)
    want = np.asarray(jremap.downsample_rgba(hi, k))
    got = remap.downsample_rgba(hi, k, device="cpu")
    assert got.dtype == torch.uint32 and tuple(got.shape) == (1, sums.size)
    np.testing.assert_array_equal(got.numpy(), want)
    on_cpu = remap.downsample_rgba(torch.from_numpy(hi), k)  # a tensor stays where it is
    np.testing.assert_array_equal(on_cpu.numpy(), want)
    s32 = sums.astype(np.float32)
    by_div = np.clip(s32 / np.float32(k * k) + np.float32(0.5), 0, 255).astype(np.uint32)
    by_rcp = np.clip(s32 * (np.float32(1) / np.float32(k * k)) + np.float32(0.5),
                     0, 255).astype(np.uint32)
    np.testing.assert_array_equal(want[0] & 0xFF, by_div)
    np.testing.assert_array_equal(by_div, by_rcp)
    assert (want >> 24 == 0xFF).all()


@pytest.mark.parametrize("k,shape", [(2, (8, 12)), (3, (9, 6, 5)), (4, (8, 8, 1)),
                                     (6, (12, 18, 3)), (1, (5, 7, 2))])
def test_downsample_rgba_random_equals_jax(k, shape):
    rng = np.random.default_rng(k * 31 + len(shape))
    hi = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jremap.downsample_rgba(hi, k))
    np.testing.assert_array_equal(remap.downsample_rgba(hi, k, device="cpu").numpy(), want)
    bits = torch.from_numpy(hi.view(np.int32))
    np.testing.assert_array_equal(
        remap.downsample_rgba(bits, k).numpy(), want)  # int32 bits in, uint32 out


def test_downsample_rgba_checks_operands():
    hi = np.zeros((8, 12), np.uint32)
    with pytest.raises(ValueError, match="not divisible"):
        remap.downsample_rgba(hi, 5, device="cpu")
    with pytest.raises(ValueError, match="factor must be"):
        remap.downsample_rgba(hi, 0, device="cpu")
    with pytest.raises(ValueError, match="factor must be"):
        remap.downsample_rgba(hi, 257, device="cpu")
    with pytest.raises(TypeError, match="torch.uint32"):
        remap.downsample_rgba(torch.zeros((8, 12), dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match=r"\[kH, kW"):
        remap.downsample_rgba(np.zeros((8,), np.uint32), 2, device="cpu")
    assert remap.downsample_rgba.launches == 0


@pytest.mark.parametrize("plates,rest", [(6, (4, 4, 3)), (2, (5, 5)), (1, (3, 3, 1)),
                                         (5, (2, 2, 7))])
def test_expand_frames_tinted_rgba_tensor_branch_equals_jax(plates, rest):
    """The tensor branch (K12's plain version here) against the JAX
    function's NumPy and jnp branches.  Channels at 0 and 255 against tints
    of 0 and 255 give t < c, where ``42 * (t - c)`` is negative and ``>>``
    must be an arithmetic shift."""
    rng = np.random.default_rng(plates)
    frames = rng.integers(0, 2**32, (plates,) + rest, dtype=np.uint64).astype(np.uint32)
    frames.reshape(plates, -1)[:, 0] = 0xFFFFFFFF  # c = 255 in every channel
    frames.reshape(plates, -1)[:, 1] = 0
    frames.reshape(plates, -1)[:, 2] = 0x00FE01FF
    want = jremap.expand_frames_tinted_rgba(frames)
    np.testing.assert_array_equal(np.asarray(
        jremap.expand_frames_tinted_rgba(jnp.asarray(frames))), want)
    np.testing.assert_array_equal(remap.expand_frames_tinted_rgba(frames), want)
    got = remap.expand_frames_tinted_rgba(torch.from_numpy(frames))
    assert got.dtype == torch.uint32 and tuple(got.shape) == (12,) + rest
    np.testing.assert_array_equal(got.numpy(), want)
    bits = remap.expand_frames_tinted_rgba(torch.from_numpy(frames.view(np.int32)))
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want)
    # t < c somewhere: plate 1's tint is (0, 0, 255) against c = 255 in red
    if plates > 1:
        assert (want[7].reshape(-1)[0] & 0xFF) == 255 + ((42 * (0 - 255)) >> 8)


def test_expand_rubix_source_dispatch(pal):
    frames = _frames(2, seed=5)
    rgba = remap.frames_to_rgba(frames, pal)
    np.testing.assert_array_equal(remap.expand_rubix_source(frames, pal),
                                  jremap.expand_rubix_source(frames, pal))
    np.testing.assert_array_equal(remap.expand_rubix_source(rgba, pal),
                                  jremap.expand_rubix_source(rgba, pal))
    got = remap.expand_rubix_source(torch.from_numpy(rgba), pal)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), jremap.expand_rubix_source(rgba, pal))
    np.testing.assert_array_equal(remap.expand_rubix_source(torch.from_numpy(frames), pal),
                                  jremap.expand_rubix_source(frames, pal))
    # the u8 expansion is host-only: a u8 tensor off the CPU is not brought down
    with pytest.raises(TypeError, match="host-only"):
        remap.expand_rubix_source(torch.zeros((2, 4, 4), dtype=torch.uint8, device="meta"), pal)
    with pytest.raises(ValueError, match="source planes"):
        remap.tint_expand_rgba(torch.zeros((7, 2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        remap.tint_expand_rgba(torch.zeros((2, 2, 2), dtype=torch.uint8))
    assert remap.tint_expand_rgba.launches == 0
