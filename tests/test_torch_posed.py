"""The port's posed path (blinky_tpu_torch's camera, kernels.posed,
kernels.static_ray, lensmap.builder.rays_to_lensmap_torch, budget
and Session.render_posed) against blinky_tpu's, on the CPU, where every
wrapper runs its plain PyTorch version.

Sizes and poses are the JAX tests' (tests/test_static_ray.py): a 64x48
screen, 48-pixel plates, five poses.  Inputs are made from numpy seeds and
handed to both packages.  Tolerances:

* 0 (bit for bit) against the JAX package's NumPy float32 path
  (``rays_to_lensmap(..., np, np.float32)``) and its NumPy and host
  functions: both round every float32 operation on its own, in one order;
* ``CPU_FUZZ`` = 0.005 of mismatched pixels against the jitted JAX pipeline
  on the same host ray table: XLA:CPU contracts and reorders float32
  arithmetic, which flips boundary texels (the JAX package's own bound
  for its jitted pipelines, tests/test_static_ray.py:46);
* 0.02 of mismatched pixels for the port's Session against the JAX
  Session: both tables take the float32 lens stage, torch's on one side and
  XLA:CPU's on the other, whose transcendentals differ in their last bits
  (the JAX package's bound for a host table against a device table,
  tests/test_static_ray.py:138).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import camera as jcamera
from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.api import Session as JSession
from blinky_tpu.bench import autobatch as jautobatch
from blinky_tpu.kernels import posed as jposed
from blinky_tpu.kernels import static_ray as jstatic
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.lensmap.builder import TINT_NONE
from blinky_tpu.lensmap.builder import rays_to_lensmap as jrays_to_lensmap
from blinky_tpu.lensmap.builder import rubix_grid_mask as jrubix_grid_mask
from blinky_tpu_torch import budget as budget_mod
from blinky_tpu_torch import camera, globes, lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
from blinky_tpu_torch.kernels import posed, static_ray
from blinky_tpu_torch.kernels.remap import expand_frames_tinted, frames_to_rgba
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.lensmap.builder import (
    plate_resolver_mode, rays_to_lensmap_torch, rubix_grid_consts, rubix_grid_lines,
)
from blinky_tpu_torch.palette import default_palette

W, H, S, B = 64, 48, 48, 5
POSES = [(0.0, 0.0, 0.0), (5.0, -12.0, 0.0), (-20.0, 33.0, 10.0),
         (89.0, 180.0, 0.0), (0.0, 271.0, -45.0)]
CPU_FUZZ = 0.005
GLOBES = ["cube", "cube_corner", "cube_edge", "fast", "tetra", "trism"]
SOURCES = ["u8", "expanded", "rgba"]
FIELDS = ("flat_idx", "valid", "tint", "plate", "px", "py")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    """A port output as NumPy, uint32 words for torch.uint32."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _source(kind, frames=None):
    frames = synthetic_cubemap_batch(S, B) if frames is None else frames
    if kind == "expanded":
        return expand_frames_tinted(frames, default_palette())
    if kind == "rgba":
        return frames_to_rgba(frames, default_palette())
    return frames


def _mismatch(a, b):
    return float((np.asarray(a) != np.asarray(b)).mean())


def _panini(globe_name="cube", w=W, h=H):
    """(JAX globe, JAX lens, port globe, port lens, scale) for panini at
    f_fov 180."""
    jg, pg = jglobes.get(globe_name), globes.get(globe_name)
    jl, pl = jlenses.get("panini", jg), lenses.get("panini", pg)
    scale = jcalc(JZoom("fov", 180), jl, w, h)
    assert scale == calc_scale(Zoom("fov", 180), pl, w, h)
    return jg, jl, pg, pl, scale


# ------------------------------------------------------------------ camera


@pytest.mark.parametrize("angles", POSES + [(33.3, -170.25, 12.5), (-89.9, 0.1, 180.0)])
def test_view_basis_bit_equal(angles):
    for a, b in zip(camera.view_basis_from_angles(*angles),
                    jcamera.view_basis_from_angles(*angles)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(camera.angle_vectors(*np.float64(angles)),
                    jcamera.angle_vectors(*np.float64(angles))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bases_from_pose_track_bit_equal():
    rng = np.random.default_rng(4)
    poses = np.concatenate([POSES, rng.uniform(-180, 180, (20, 3))])
    got = posed.bases_from_pose_track(poses)
    assert got.shape == (25, 3, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jposed.bases_from_pose_track(poses))


# --------------------------------------------------------- posed helpers


@pytest.mark.parametrize("w,h,k", [(64, 48, 1), (64, 48, 2), (64, 48, 4), (64, 48, 0),
                                   (64, 48, 5), (60, 36, 3), (64, 48, 8), (66, 48, 3)])
def test_check_render_scale(w, h, k):
    """The same verdict and the same message as the JAX package."""
    try:
        jposed.check_render_scale(w, h, k)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        posed.check_render_scale(w, h, k)
    else:
        with pytest.raises(ValueError) as got:
            posed.check_render_scale(w, h, k)
        assert str(got.value) == want


@pytest.mark.parametrize("batch,n", [(153, 12 * 1080 * 1080), (154, 12 * 1080 * 1080),
                                     (1, 2**31 - 1), (1, 2**31), (2**16, 2**15)])
def test_flat_gather_safe(batch, n):
    assert posed.flat_gather_safe(batch, n) == jposed.flat_gather_safe(batch, n)


# (k, rgba, build width): a ragged width of 7 (K5's scalar kernel on a card)
# and one that is a multiple of four (its vector kernel at k = 1 and 2)
GATHER_CASES = [pytest.param(k, rgba, wb, id=f"{'u32' if rgba else 'u8'}-{k}"
                             + ("" if wb == 7 else f"-w{wb}"))
                for rgba in (False, True) for wb in (7, 8) for k in (1, 2, 3, 4)]


@pytest.mark.parametrize("k,rgba,wb", GATHER_CASES)
def test_gather_posed_plain_equals_jax(k, rgba, wb):
    """K5's plain version against the JAX gather tail, with indices out of
    range either side and holes in the mask."""
    rng = np.random.default_rng(10 * k + rgba + (0 if wb == 7 else 100))
    N, hb = 40, 6
    dt = np.uint32 if rgba else np.uint8
    src = rng.integers(0, 2**32 if rgba else 256, (B, N), dtype=np.uint64).astype(dt)
    bg = rng.integers(0, 2**32 if rgba else 256, (hb * k, wb * k), dtype=np.uint64).astype(dt)
    idx = rng.integers(-N - 5, 2 * N + 5, (B, hb, wb)).astype(np.int32)
    valid = rng.random((B, hb, wb)) < 0.7
    want = np.asarray(jposed.gather_posed(jnp.asarray(src), jnp.asarray(idx),
                                          jnp.asarray(valid), jnp.asarray(bg), k, True))
    bits = (lambda a: _t(a.view(np.int32))) if rgba else _t
    got = posed.gather_posed(bits(src), _t(idx), _t(valid), bits(bg), k)
    assert got.shape == (B, hb * k, wb * k)
    np.testing.assert_array_equal(got.numpy().view(dt), want)


# (kind, batch): the five-pose batch; ragged contiguous batches (K7's span
# tiles on a card, B = 1 and 3 below and 63 above its vector path's 16 u8
# poses); batch slices of an 8-pose batch (its slice tiles and, one pose
# wide, its column path)
PREP_CASES = [pytest.param(kind, batch, id=kind + ("" if batch is None else f"-{batch}"))
              for kind in SOURCES for batch in (None, 1, 3, 63, "3:8", "5:6")]


@pytest.mark.parametrize("kind,batch", PREP_CASES)
def test_prep_posed_inputs_equals_jax(kind, batch):
    """The pose-major source: P < 6 planes pad to 6, the expanded layout
    stays 12, RGBA rides as int32 bits; bases are cast to float32.  Ragged
    batches and batch slices (a strided tensor on the port's side) lay out
    as the JAX package's transpose does."""
    lo = hi = None
    if isinstance(batch, str):
        lo, hi = map(int, batch.split(":"))
        frames = _source(kind, synthetic_cubemap_batch(S, 8))
    else:
        frames = _source(kind, None if batch is None else synthetic_cubemap_batch(S, batch))
    if kind == "u8":
        frames = frames[:4]
    port = frames
    if lo is not None:
        port = torch.from_numpy(frames)[..., lo:hi]
        frames = frames[..., lo:hi]
    n = frames.shape[-1]
    bases = jposed.bases_from_pose_track([POSES[i % len(POSES)] for i in range(n)])
    rgba = kind == "rgba"
    jbg = jnp.zeros((H, W), jnp.uint32 if rgba else jnp.uint8)
    jsrc, jb, jexp = jposed.prep_posed_inputs(frames, bases, S, jnp.float32, jbg)
    bg = torch.zeros((H, W), dtype=torch.int32 if rgba else torch.uint8)
    src, b, exp = posed.prep_posed_inputs(port, bases, S, bg, "cpu")
    assert exp == jexp
    np.testing.assert_array_equal(src.numpy().view(np.uint32) if rgba else src.numpy(),
                                  np.asarray(jsrc))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert b.dtype == torch.float32


@pytest.mark.parametrize("kind", ["u8", "expanded", "rgba"])
def test_prep_posed_inputs_one_pose_is_a_view(kind):
    """One pose of 6 or 12 contiguous planes: the pose-major array is the
    frames themselves (shared storage), equal to the copy path; 4 planes at
    one pose still pad with zero planes."""
    frames = torch.from_numpy(_source(kind)[..., 2:3].copy())
    if kind == "rgba":
        frames = frames.view(torch.uint32)
    bg = torch.zeros((H, W), dtype=torch.int32 if kind == "rgba" else torch.uint8)
    basis = jposed.bases_from_pose_track(POSES[2:3])
    src, _, expanded = posed.prep_posed_inputs(frames, basis, S, bg, "cpu")
    bits = frames.view(torch.int32) if kind == "rgba" else frames
    assert src.untyped_storage().data_ptr() == frames.untyped_storage().data_ptr()
    assert torch.equal(src, posed.posed_layout_plain(bits, 12 if expanded else 6))
    if kind == "u8":
        src4, _, _ = posed.prep_posed_inputs(frames[:4], basis, S, bg, "cpu")
        assert src4.untyped_storage().data_ptr() != frames.untyped_storage().data_ptr()
        assert torch.equal(src4[:, :4 * S * S], frames[:4].reshape(1, -1))
        assert not src4[:, 4 * S * S:].any()


_U8_MIN, _RGBA_MIN = posed.LONG_ROW_MIN_BYTES[1], posed.LONG_ROW_MIN_BYTES[4]
_CELL_ROW = 6 * 1080 * 1080  # the posed cell's pose rows: bytes of u8


@pytest.mark.parametrize("el,row_bytes,ld_bytes,out_row_bytes,src_off,out_off,long_rows", [
    (1, _U8_MIN, _U8_MIN, _CELL_ROW, 0, 0, True),
    (1, _U8_MIN - 16, _U8_MIN - 16, _CELL_ROW, 0, 0, False),  # under the threshold
    (1, _U8_MIN + 16, _U8_MIN + 16, _CELL_ROW, 0, 0, True),
    (4, _RGBA_MIN, _RGBA_MIN, 4 * _CELL_ROW, 0, 0, True),
    (4, _RGBA_MIN - 16, _RGBA_MIN - 16, 4 * _CELL_ROW, 0, 0, False),
    (4, _RGBA_MIN + 16, _RGBA_MIN + 16, 4 * _CELL_ROW, 0, 0, True),
    (1, 64, 64, _CELL_ROW, 0, 0, False),         # u8 B = 64: the vector path
    (1, 1024, 1024, _CELL_ROW, 0, 0, True),      # the posed cell, u8 B = 1024
    (1, 2048, 2048, _CELL_ROW, 0, 0, True),      # u8 B = 2048
    (4, 256, 256, 4 * _CELL_ROW, 0, 0, True),    # RGBA B = 64
    (4, 128, 128, 4 * _CELL_ROW, 0, 0, False),   # RGBA B = 32: the vector path
    (1, 1024, 2048, _CELL_ROW, 0, 0, True),      # a batch slice, rows 2048 bytes apart
    (1, 1024, 1024 + 8, _CELL_ROW, 0, 0, False),  # a row stride off 16 bytes
    (1, 1024 + 4, 1024 + 4, _CELL_ROW, 0, 0, False),  # no multiple of 16 bytes
    (1, 1024, 1024, 6 * 5 * 5, 0, 0, False),     # pose rows off 16 bytes (S = 5)
    (1, 1024, 1024, _CELL_ROW, 1, 0, False), (1, 1024, 1024, _CELL_ROW, 4, 0, False),
    (1, 1024, 1024, _CELL_ROW, 8, 0, False),     # frames off 16 bytes
    (1, 1024, 1024, _CELL_ROW, 0, 4, False), (1, 1024, 1024, _CELL_ROW, 0, 8, False),
    (1, 1024, 1024, _CELL_ROW, 16, 32, True),
])
def test_long_row_path_decides_on_row_bytes_and_alignment(el, row_bytes, ld_bytes, out_row_bytes,
                                                          src_off, out_off, long_rows):
    base = 1 << 40
    assert posed.long_row_path(el, row_bytes, ld_bytes, out_row_bytes, base + src_off,
                               base + out_off) is long_rows


@pytest.mark.parametrize("dtype,B", [(torch.uint8, 1024), (torch.int32, 64),
                                     (torch.uint8, 64)])
def test_posed_layout_on_the_cpu_runs_the_plain_version(dtype, B):
    """On the CPU neither K7 counter moves, whatever the row, and the
    wrapper returns the plain version's layout, whole or as a batch slice."""
    gen = torch.Generator().manual_seed(B)
    frames = torch.randint(0, 256, (3, 8, 8, B), dtype=torch.uint8, generator=gen).to(dtype)
    n0, l0 = posed.posed_layout.launches, posed.posed_layout.long_row_launches
    for x in (frames, frames[..., B // 2:]):
        got = posed.posed_layout(x, 6)
        assert torch.equal(got, posed.posed_layout_plain(x, 6))
        assert torch.equal(got[:, :3 * 64], x.permute(3, 0, 1, 2).reshape(x.shape[-1], -1))
    assert (posed.posed_layout.launches, posed.posed_layout.long_row_launches) == (n0, l0)


# the Session's default grid, two others, one whose unit is a whole 30
# pixels at S = 1080 and 2160 (px / unit lands on block edges exactly), and
# f_rubixgrid 0 0 0 (an infinite unit: no grid lines)
GRIDS = [(10, 4.0, 1.0), (7.0, 3.3, 1.7), (3, 2.5, 0.5), (7, 4.0, 1.0), (0, 0.0, 0.0)]


@pytest.mark.parametrize("platesize", [64, 1080, 2160])
@pytest.mark.parametrize("grid", GRIDS, ids=["default", "f32", "coarse", "exact-edges",
                                             "no-grid"])
def test_rubix_grid_lines_equal_fmod_test(platesize, grid):
    """K6's grid-line table against the plain version's float64 fmod test
    and the JAX package's rubix_grid_mask (NumPy, x64), at every (px, py),
    both fed the float32-rounded grid parameters rubix_grid_consts uses."""
    lines = rubix_grid_lines(platesize, *grid)
    assert lines.shape == (platesize,) and lines.dtype == bool
    unit, block, pad = rubix_grid_consts(platesize, *grid)
    px = torch.arange(platesize)
    plain = torch.fmod(px.to(torch.float64) / torch.tensor(unit, dtype=torch.float64),
                       block) < pad
    np.testing.assert_array_equal(lines, plain.numpy())
    grid32 = tuple(np.float32(v) for v in grid)
    py, pxx = np.meshgrid(np.arange(platesize), np.arange(platesize), indexing="ij")
    want = jrubix_grid_mask(pxx, py, platesize, *grid32, np)
    np.testing.assert_array_equal(lines[pxx] | lines[py], want)
    if grid == (7, 4.0, 1.0) and platesize > 64:
        u = 30 * platesize // 1080  # px = u is the first texel past the first line
        assert unit == u and lines[u - 1] and not lines[u]
    if grid == (0, 0.0, 0.0):
        assert not lines.any()


def test_posed_background_dtype_guards():
    """Both background/frames dtype mismatches raise, as in the JAX
    package; so do a wrong plate size and a wrong bases shape."""
    frames = synthetic_cubemap_batch(S, 2)
    bases = np.tile(np.eye(3)[None], (2, 1, 1))
    with pytest.raises(ValueError, match="u8 frames"):
        posed.prep_posed_inputs(frames, bases, S, torch.zeros((H, W), dtype=torch.int32), "cpu")
    with pytest.raises(ValueError, match="RGBA frames"):
        posed.prep_posed_inputs(frames_to_rgba(frames, default_palette()), bases, S,
                                torch.zeros((H, W), dtype=torch.uint8), "cpu")
    bg = torch.zeros((H, W), dtype=torch.uint8)
    with pytest.raises(ValueError, match="platesize"):
        posed.prep_posed_inputs(frames, bases, S + 2, bg, "cpu")
    with pytest.raises(ValueError, match="bases"):
        posed.prep_posed_inputs(frames, bases[:1], S, bg, "cpu")
    _, _, pg, pl, scale = _panini()
    k = static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S,
                                        background=np.zeros((H, W), np.uint32),
                                        device="cpu")
    with pytest.raises(ValueError, match="u8 frames"):
        k(frames, bases)


# ------------------------------------------------- the float32 ray resolve


@pytest.mark.parametrize("globe_name", GLOBES)
@pytest.mark.parametrize("grid", [(10, 4.0, 1.0), (7.0, 3.3, 1.7)], ids=["default", "f32"])
def test_rays_to_lensmap_torch_equals_numpy_f32(globe_name, grid):
    """rays_to_lensmap_torch (K6's plain version) against the JAX package's
    NumPy float32 builder, every field, all five poses in one batched call.
    The non-default rubix grid is passed to both as float32, as the jitted
    pipeline carries it."""
    jg, jl, pg, _, scale = _panini(globe_name)
    t = jstatic.ray_table_from_lens(jl, scale, W, H, backend="numpy")
    bases = jposed.bases_from_pose_track(POSES)
    grid32 = tuple(np.float32(v) for v in grid)
    got = rays_to_lensmap_torch(pg, _t(t.vx), _t(t.vy), _t(t.vz), _t(t.lens_valid), S,
                                *(float(v) for v in grid32), view_basis=_t(bases))
    for b, basis in enumerate(bases):
        want = jrays_to_lensmap(jg, t.vx, t.vy, t.vz, t.lens_valid, S, *grid32,
                                np, np.float32, view_basis=tuple(basis))
        for f in FIELDS:
            np.testing.assert_array_equal(got[f][b].numpy(), np.asarray(want[f]), err_msg=f)
        np.testing.assert_array_equal(got["plates_used"][b].numpy(),
                                      np.asarray(want["plates_used"]))


def test_rays_to_lensmap_torch_odd_rays():
    """NaN, inf and zero-length rays resolve as in the JAX package: a zero
    ray stays unnormalized, NaN dots keep plate 0, nothing casts a NaN."""
    jg, jl, pg, _, scale = _panini("fast")
    t = jstatic.ray_table_from_lens(jl, scale, W, H, backend="numpy")
    vx, vy, vz = (np.array(a) for a in (t.vx, t.vy, t.vz))
    odd = [(0.0, 0.0, 0.0), (np.nan, 0.3, 1.0), (np.inf, 0.0, 1.0), (0.0, -np.inf, np.inf),
           (1e-30, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 0.0, 1e-38)]
    for i, ray in enumerate(odd):
        vx[i, i], vy[i, i], vz[i, i] = ray
    bases = jposed.bases_from_pose_track(POSES)
    for name in ("fast", "cube"):
        g, p = jglobes.get(name), globes.get(name)
        got = rays_to_lensmap_torch(p, _t(vx), _t(vy), _t(vz), _t(t.lens_valid), S,
                                    10.0, 4.0, 1.0, view_basis=_t(bases))
        for b, basis in enumerate(bases):
            want = jrays_to_lensmap(g, vx, vy, vz, t.lens_valid, S, 10.0, 4.0, 1.0,
                                    np, np.float32, view_basis=tuple(basis))
            for f in FIELDS:
                np.testing.assert_array_equal(got[f][b].numpy(), np.asarray(want[f]))


def test_resolver_modes():
    """The fast globe takes its resolver's float32 twin; the others the
    max-dot select; any other resolver (a script globe's) is evaluated on
    tensors and given to the kernels ("script", resolver mode 2), unless it
    does not evaluate on tensors (jittable False), which raises: such a
    globe has no device path and renders on the exact host path."""
    import dataclasses

    assert [plate_resolver_mode(globes.get(n)) for n in GLOBES] == [
        "fast" if n == "fast" else "maxdot" for n in GLOBES]
    lua_like = dataclasses.replace(globes.get("fast"), plate_resolver=lambda *a: 0)
    assert plate_resolver_mode(lua_like) == "script"
    scalar_only = dataclasses.replace(lua_like, jittable=False)
    with pytest.raises(ValueError, match="jittable"):
        plate_resolver_mode(scalar_only)
    _, _, _, pl, scale = _panini()
    with pytest.raises(ValueError, match="jittable"):
        static_ray.StaticRayPosedKernel(pl, scalar_only, W, H, scale, platesize=S,
                                        device="cpu")
    # every ray of the constant resolver lands on plate 0
    k = static_ray.StaticRayPosedKernel(pl, lua_like, W, H, scale, platesize=S, device="cpu")
    plates = static_ray.script_pose_plates(k.ray_table, torch.zeros((2, 3, 3)), lua_like)
    assert plates.dtype == torch.int8 and plates.shape == (2, H, W)
    assert bool((plates == 0).all())


# -------------------------------------------------------------- ray tables


@pytest.mark.parametrize("globe_name", ["cube", "fast", "tetra"])
def test_ray_table_from_lens_equals_jax(globe_name):
    jg, jl, pg, pl, scale = _panini(globe_name)
    want = jstatic.ray_table_from_lens(jl, scale, W, H, backend="numpy")
    got = static_ray.ray_table_from_lens(pl, scale, W, H, backend="numpy")
    assert isinstance(static_ray.ray_table_from_lens(pl, scale, W, H).vx, np.ndarray)
    assert (got.width_px, got.height_px, got.source) == (W, H, "lens")
    for f in ("vx", "vy", "vz", "lens_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    # the float32 lens stage: tensors on the device asked for, within a few
    # float32 ulps of the JAX package's jitted lens stage (the two evaluate
    # atan2, sin and cos with different last bits); the mask is equal
    f32 = static_ray.ray_table_from_lens(pl, scale, W, H, backend="torch", device="cpu")
    jf32 = jstatic.ray_table_from_lens(jl, scale, W, H, dtype=jnp.float32, backend="jax")
    for f in ("vx", "vy", "vz"):
        assert getattr(f32, f).dtype == torch.float32 and getattr(f32, f).is_contiguous()
        np.testing.assert_allclose(getattr(f32, f).numpy(), np.asarray(getattr(jf32, f)),
                                   rtol=0, atol=4e-6)
    np.testing.assert_array_equal(f32.lens_valid.numpy(), np.asarray(jf32.lens_valid))
    assert static_ray.build_ray_table(pl, pg, scale, W, H, device="cpu").vx.dtype == torch.float32
    with pytest.raises(ValueError, match="backend"):
        static_ray.ray_table_from_lens(pl, scale, W, H, backend="jax")
    dev = got.device("cpu")
    assert dev.vx.dtype == torch.float32 and dev.lens_valid.dtype == torch.bool


@pytest.mark.parametrize("globe_name", ["cube", "fast", "tetra"])
def test_ray_table_from_lensmap_equals_jax(globe_name):
    jg, jl, pg, pl, scale = _panini(globe_name)
    want = jstatic.ray_table_from_lensmap(
        jbuild(jl, jg, scale, W, H, S, backend="numpy").to_numpy(), jg)
    got = static_ray.ray_table_from_lensmap(build_lensmap(pl, pg, scale, W, H, S), pg)
    assert got.source == "lensmap"
    for f in ("vx", "vy", "vz", "lens_valid"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))


# ------------------------------------------------------ the static-ray kernel


def _jax_numpy_f32_screens(kind, k, frames, bg=None, jg=None, t=None):
    """The JAX package's posed screens through its NumPy float32 index
    math and its gather tail: per pose ``rays_to_lensmap(..., np,
    np.float32)`` of the host ray table (panini's, unless globe *jg* and
    table *t* are given), the expanded offset, then ``gather_posed``."""
    if t is None:
        jg, jl, _, _, scale = _panini()
        t = jstatic.ray_table_from_lens(jl, scale * k, W // k, H // k, backend="numpy")
    bases = jposed.bases_from_pose_track(POSES)
    rgba = kind == "rgba"
    jbg = jnp.asarray(np.zeros((H, W), np.uint32 if rgba else np.uint8) if bg is None else bg)
    src, _, expanded = jposed.prep_posed_inputs(frames, bases, S, jnp.float32, jbg)
    idx, valid = [], []
    for basis in bases:
        lm = jrays_to_lensmap(jg, t.vx, t.vy, t.vz, t.lens_valid, S, 10.0, 4.0, 1.0,
                              np, np.float32, view_basis=tuple(basis))
        i = lm["flat_idx"]
        if expanded:
            i = i + np.where((lm["tint"] != TINT_NONE) & lm["valid"], 6 * S * S, 0)
        idx.append(i.astype(np.int32))
        valid.append(lm["valid"])
    return np.asarray(jposed.gather_posed(src, jnp.asarray(np.stack(idx)),
                                          jnp.asarray(np.stack(valid)), jbg, k, True))


@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("k", [1, 2])
def test_static_ray_kernel_equals_jax_numpy_f32(kind, k):
    """StaticRayPosedKernel on the CPU (rays_to_lensmap_torch +
    gather_posed_plain) bit-equals the JAX package's NumPy float32 index
    math fed to its gather tail."""
    _, _, pg, pl, scale = _panini()
    frames = _source(kind)
    rng = np.random.default_rng(k)
    bg = rng.integers(0, 256, (H, W), dtype=np.uint8)
    if kind == "rgba":
        bg = frames_to_rgba(bg, default_palette())
    # the host float64 table on both sides (the kernel's own default is the
    # float32 lens stage, held by a tolerance in test_posed_remap_kernel_*)
    table = static_ray.ray_table_from_lens(pl, scale * k, W // k, H // k, backend="numpy")
    kern = static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S,
                                           background=bg, render_scale=k,
                                           ray_table=table, device="cpu")
    got = kern(frames, posed.bases_from_pose_track(POSES))
    assert got.dtype == (torch.uint32 if kind == "rgba" else torch.uint8)
    np.testing.assert_array_equal(_np(got), _jax_numpy_f32_screens(kind, k, frames, bg))


@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("k", [1, 2])
def test_static_ray_kernel_within_cpu_fuzz_of_jitted_jax(kind, k):
    """Against the JAX package's jitted StaticRayPosedKernel fed the same
    host ray table: XLA:CPU's contraction flips a few boundary texels."""
    jg, jl, pg, pl, scale = _panini()
    frames = _source(kind)
    bg = np.zeros((H, W), np.uint32 if kind == "rgba" else np.uint8)
    jt = jstatic.ray_table_from_lens(jl, scale * k, W // k, H // k, backend="numpy")
    jk = jstatic.StaticRayPosedKernel(jl, jg, W, H, scale, platesize=S, background=bg,
                                      render_scale=k, ray_table=jt)
    table = static_ray.RayTable(W // k, H // k, jt.vx, jt.vy, jt.vz, jt.lens_valid)
    pk = static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S, background=bg,
                                         render_scale=k, ray_table=table, device="cpu")
    bases = jposed.bases_from_pose_track(POSES)
    got, want = _np(pk(frames, bases)), np.asarray(jk(frames, bases))
    n_bad = int((got != want).sum())
    print(f"{kind} k={k}: {n_bad} of {got.size} pixels differ from the jitted pipeline")
    assert _mismatch(got, want) <= CPU_FUZZ


def test_static_ray_kernel_validates():
    _, _, pg, pl, scale = _panini()
    t = static_ray.ray_table_from_lens(pl, scale, W - 2, H)
    with pytest.raises(ValueError, match="ray table"):
        static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S, ray_table=t,
                                        device="cpu")
    with pytest.raises(ValueError, match="render_scale"):
        static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S, render_scale=5,
                                        device="cpu")
    kern = static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S, device="cpu")
    src, bases, _ = posed.prep_posed_inputs(_source("u8")[..., :2],
                                            np.tile(np.eye(3), (2, 1, 1)), S,
                                            kern.background, "cpu")
    with pytest.raises(ValueError, match="texels a pose"):
        static_ray.static_ray_posed(src[:, :-1].contiguous(), kern.ray_table, bases, pg, S,
                                    10.0, 4.0, 1.0, False, kern.background, 1)
    with pytest.raises(ValueError, match="bases"):
        static_ray.static_ray_posed(src, kern.ray_table, bases.double(), pg, S,
                                    10.0, 4.0, 1.0, False, kern.background, 1)
    with pytest.raises(ValueError, match="ray table vx"):
        static_ray.static_ray_posed(src, static_ray.ray_table_from_lens(pl, scale, W, H),
                                    bases, pg, S, 10.0, 4.0, 1.0, False, kern.background, 1)


def test_unported_posed_entry_points_raise():
    """The two pose-sharded functions, ported with the multi-GPU slice
    (tests/test_torch_sharding.py holds their outputs), keep the JAX names
    and raise on a pose track that does not match the batch and on a batch
    that does not split evenly over the mesh."""
    from blinky_tpu_torch.parallel import (
        make_mesh, posed_remap_sharded, static_ray_posed_sharded,
    )

    _, _, pg, pl, scale = _panini()
    mesh2 = make_mesh(2, 1, devices=[torch.device("cpu")] * 2)
    frames = _source("u8")  # B = 5 poses: odd
    bases = posed.bases_from_pose_track(POSES)
    kerns = (posed.PosedRemapKernel(pl, pg, W, H, scale, platesize=S, device="cpu"),
             static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S, device="cpu"))
    for fn, what, kern in ((jposed.posed_remap_sharded, posed_remap_sharded, kerns[0]),
                           (jstatic.static_ray_posed_sharded,
                            static_ray_posed_sharded, kerns[1])):
        assert fn.__name__ == what.__name__
        with pytest.raises(ValueError, match="bases must be"):
            what(kern, frames, bases[:2], mesh2)
        with pytest.raises(ValueError, match="split evenly"):
            what(kern, frames, bases, mesh2)


# ---------------------------------------- the fused posed pipeline and sweep


@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("k", [1, 2])
def test_posed_remap_kernel_within_cpu_fuzz_of_jax(kind, k):
    """PosedRemapKernel (the float32 lens stage, then the static-ray
    resolve and gather) against the JAX package's jitted fused pipeline.
    The resolve alone is within CPU_FUZZ of XLA:CPU's on the same rays
    (test_static_ray_kernel_within_cpu_fuzz_of_jitted_jax); here the rays
    come from two lens stages, torch's and XLA:CPU's, whose atan2, sin and
    cos differ in their last bits, so the bound is the JAX package's own for
    two differently evaluated ray tables, 0.02 of the pixels
    (tests/test_static_ray.py:138).  Measured: 0.0025-0.0061."""
    jg, jl, pg, pl, scale = _panini()
    frames = _source(kind)
    rng = np.random.default_rng(k + 10)
    bg = rng.integers(0, 256, (H, W), dtype=np.uint8)
    if kind == "rgba":
        bg = frames_to_rgba(bg, default_palette())
    jk = jposed.PosedRemapKernel(jl, jg, W, H, scale, platesize=S, background=bg,
                                 dtype=jnp.float32, render_scale=k)
    pk = posed.PosedRemapKernel(pl, pg, W, H, scale, platesize=S, background=bg,
                                render_scale=k, device="cpu")
    for f in ("width_px", "height_px", "render_scale", "platesize", "scale", "numcells",
              "cell_size", "pad_size"):
        assert getattr(pk, f) == getattr(jk, f), f
    bases = jposed.bases_from_pose_track(POSES)
    got, want = _np(pk(frames, bases)), np.asarray(jk(frames, bases))
    assert got.dtype == want.dtype and got.shape == want.shape == (B, H, W)
    print(f"{kind} k={k}: {int((got != want).sum())} of {got.size} pixels differ")
    assert _mismatch(got, want) <= 0.02
    # the same values as the static-ray kernel on a float32 lens-stage table
    sk = static_ray.StaticRayPosedKernel(pl, pg, W, H, scale, platesize=S, background=bg,
                                         render_scale=k, device="cpu")
    np.testing.assert_array_equal(got, _np(sk(frames, bases)))


def test_posed_remap_kernel_constructor_errors():
    """The constructor's checks, as tests/test_posed.py holds them for the
    JAX kernel: a bad render scale, an odd build grid, a background of the
    wrong size, a u8/u32 mismatch between frames and background, a bases
    array of the wrong batch, a platesize mismatch, a forward-only lens."""
    jg, jl, pg, pl, scale = _panini()
    for kw, match in ((dict(render_scale=5), "not divisible"),
                      (dict(render_scale=0), ">= 1"),
                      (dict(background=np.zeros((10, 10), np.uint8)), "background must be")):
        with pytest.raises(ValueError, match=match):
            jposed.PosedRemapKernel(jl, jg, W, H, scale, **kw)
        with pytest.raises(ValueError, match=match):
            posed.PosedRemapKernel(pl, pg, W, H, scale, device="cpu", **kw)
    with pytest.raises(ValueError, match="odd"):
        jposed.PosedRemapKernel(jl, jg, 60, 40, scale, render_scale=4)
    with pytest.raises(ValueError, match="odd"):
        posed.PosedRemapKernel(pl, pg, 60, 40, scale, render_scale=4, device="cpu")
    frames = _source("u8")
    bases = jposed.bases_from_pose_track(POSES)
    pk = posed.PosedRemapKernel(pl, pg, W, H, scale, platesize=S, device="cpu")
    jk = jposed.PosedRemapKernel(jl, jg, W, H, scale, platesize=S)
    for k_ in (jk, pk):
        with pytest.raises(ValueError, match="bases must be"):
            k_(frames, bases[:3])
        with pytest.raises(ValueError, match="platesize"):
            k_(frames[:, :40, :40], bases)
        with pytest.raises(ValueError, match="RGBA frames need"):
            k_(_source("rgba"), bases)
    flat = posed.PosedRemapKernel(pl, pg, W, H, scale, platesize=S, device="cpu",
                                  background=np.zeros(H * W, np.uint8))  # a flat one reshapes
    assert tuple(flat(frames, bases).shape) == (B, H, W)
    rgba_bg = np.zeros((H, W), np.uint32)
    with pytest.raises(ValueError, match="u8 frames need"):
        posed.PosedRemapKernel(pl, pg, W, H, scale, platesize=S, background=rgba_bg,
                               device="cpu")(frames, bases)
    import dataclasses
    fwd = dataclasses.replace(pl, map_type="forward")
    with pytest.raises(ValueError, match="forward-only"):
        posed.PosedRemapKernel(fwd, pg, W, H, scale, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        posed.PosedRemapKernel(pl, pg, W, H, scale, dtype=torch.float64, device="cpu")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        posed.PosedRemapKernel(pl, pg, W, H, scale)  # the card, and none here


SWEEP_FOVS = [100, 150, 200, 250, 330]
# The fused sweep against the JAX package's: every step is one float32 build
# against another, which differ by one texel where a ray falls on a texel or
# plate boundary (px or py off by one; the widest steps amplify the rays
# most).  Measured at this size: at most 0.0283 of a step's pixels, 0.018 of
# the ramp's.  The bounds are about twice that; a wrong plate of six or a
# dropped tinted-half offset moves a sixth or more of a step.
SWEEP_STEP_FUZZ = 0.06
SWEEP_FUZZ = 0.04


def _sweep_loop(sess, frame, rubix):
    """One f_fov and one render a zoom step: (scales, screens)."""
    scales, screens = [], []
    for fov in SWEEP_FOVS:
        sess.cmd(f"f_fov {fov}")
        screens.append(_np(sess.render(frame, rubix=rubix)))
        scales.append(sess.lensmap.scale)
    return scales, np.stack(screens)


@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("globe_name", ["cube", "fast"])
def test_zoom_sweep_remap_equals_per_step_loop(kind, globe_name):
    """The fused sweep equals the port's own per-step loop
    (Session(backend="torch"): one f_fov and one render a step) bit for
    bit, as tests/test_cli_pipeline.py holds the JAX sweep to its loop.
    Against the JAX package's fused sweep each step is within
    SWEEP_STEP_FUZZ of its pixels and the ramp within SWEEP_FUZZ."""
    frame = _source(kind)[..., 0]
    rng = np.random.default_rng(4)
    bg = rng.integers(0, 256, (H, W), dtype=np.uint8)
    sess = Session(W, H, platesize=S, device="cpu", backend="torch")
    sess.cmd(f"f_globe {globe_name}")
    sess.set_background(bg)
    scales, want = _sweep_loop(sess, frame, rubix=kind == "expanded")
    bg_ = frames_to_rgba(bg, default_palette()) if kind == "rgba" else bg
    got = posed.zoom_sweep_remap(sess.lens, sess.globe, scales, frame, W, H,
                                 background=bg_, device="cpu")
    assert got.dtype == (torch.uint32 if kind == "rgba" else torch.uint8)
    np.testing.assert_array_equal(_np(got), want)
    jg = jglobes.get(globe_name)
    jwant = np.asarray(jposed.zoom_sweep_remap(
        jlenses.get("panini", jg), jg, scales, frame, W, H, background=bg_,
        dtype=jnp.float32))
    steps = [_mismatch(_np(got)[n], jwant[n]) for n in range(len(SWEEP_FOVS))]
    print(f"{kind} {globe_name}: of each step's pixels "
          f"{', '.join(f'{x:.4f}' for x in steps)} differ from the JAX sweep")
    assert max(steps) <= SWEEP_STEP_FUZZ, steps
    assert _mismatch(_np(got), jwant) <= SWEEP_FUZZ


@pytest.mark.parametrize("name", ["fisheye1", "winkeltripel", "cube", "mollweide"])
def test_zoom_sweep_remap_other_lenses_and_grids(name):
    """Lenses with holes, a solver loop and a cell layout through the fused
    sweep, with a non-default rubix grid, equal their per-step loop; three
    source planes pad to six."""
    frame = _source("expanded")[..., 1]
    sess = Session(W, H, platesize=S, device="cpu", backend="torch")
    sess.cmd(f"f_lens {name}; f_rubixgrid 7 2.5 1.5")
    scales, want = _sweep_loop(sess, frame, rubix=True)
    got = posed.zoom_sweep_remap(sess.lens, sess.globe, scales, frame, W, H,
                                 numcells=7, cell_size=2.5, pad_size=1.5, device="cpu")
    np.testing.assert_array_equal(_np(got), want)
    three = _source("u8")[:3, ..., 0]
    scales, want = _sweep_loop(sess, three, rubix=False)
    got = posed.zoom_sweep_remap(sess.lens, sess.globe, scales, three, W, H, device="cpu")
    np.testing.assert_array_equal(_np(got), want)


def test_zoom_sweep_remap_errors():
    """The checks of blinky_tpu.kernels.posed.zoom_sweep_remap (:340-362):
    a forward-only lens, RGBA frames on a u8 background and the reverse; and
    the port's own: more than six planes that are not twelve, a float64
    build, the card as the default device."""
    import dataclasses
    jg, jl, pg, pl, scale = _panini()
    frame = _source("u8")[..., 0]
    rgba = _source("rgba")[..., 0]
    with pytest.raises(ValueError, match="forward-only"):
        posed.zoom_sweep_remap(dataclasses.replace(pl, map_type="forward"), pg, [scale],
                               frame, W, H, device="cpu")
    for fn, lens, globe, kw in ((jposed.zoom_sweep_remap, jl, jg, {}),
                                (posed.zoom_sweep_remap, pl, pg, dict(device="cpu"))):
        with pytest.raises(ValueError, match="RGBA frames need"):
            fn(lens, globe, [scale], rgba, W, H, **kw)
        with pytest.raises(ValueError, match="u8 frames need"):
            fn(lens, globe, [scale], frame, W, H,
               background=np.zeros((H, W), np.uint32), **kw)
    with pytest.raises(ValueError, match="source planes"):
        posed.zoom_sweep_remap(pl, pg, [scale], np.zeros((7, S, S), np.uint8), W, H,
                               device="cpu")
    with pytest.raises(ValueError, match="float32"):
        posed.zoom_sweep_remap(pl, pg, [scale], frame, W, H, dtype=torch.float64,
                               device="cpu")
    with pytest.raises(ValueError, match="must be"):
        posed.zoom_sweep_remap(pl, pg, [scale], frame, W, H,
                               background=np.zeros((3, 3), np.uint8), device="cpu")
    empty = posed.zoom_sweep_remap(pl, pg, [], frame, W, H, device="cpu")
    assert tuple(empty.shape) == (0, H, W)
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        posed.zoom_sweep_remap(pl, pg, [scale], frame, W, H)  # the card, and none here


@pytest.mark.parametrize("layout", ["transpose12", "pose_major"])
@pytest.mark.parametrize("kind", SOURCES)
def test_render_posed_takes_strided_frames(kind, layout):
    """Frames whose plate axes are swapped in memory, and frames stored pose
    after pose ([B, P, S, S] permuted to [P, S, S, B]), render like the
    contiguous array, bit for bit, and within the Session bound of
    blinky_tpu on the same values; the pose-major tensor is used in place."""
    js, ps = _sessions()
    fr = _source(kind)
    t = torch.from_numpy(fr.view(np.int32) if kind == "rgba" else fr)
    if layout == "transpose12":
        x = t.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        x = t.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    assert not x.is_contiguous() and torch.equal(x, t)
    bg = torch.zeros((H, W), dtype=x.dtype)
    if kind == "rgba":
        x = x.view(torch.uint32)
    if layout == "pose_major":
        src, _, _ = posed.prep_posed_inputs(x, np.tile(np.eye(3), (B, 1, 1)), S, bg, "cpu")
        assert src.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    poses = np.asarray(POSES)
    got = ps.render_posed(x, poses)
    np.testing.assert_array_equal(_np(got), _np(ps.render_posed(fr, poses)))
    assert _mismatch(_np(got), np.asarray(js.render_posed(fr, poses))) <= 0.02
    np.testing.assert_array_equal(
        _np(ps.render_posed(x[..., :2], poses[:2], exact=True)),
        np.asarray(js.render_posed(fr[..., :2], poses[:2], exact=True)))


# ----------------------------------------------------------------- batching


def test_autobatch_models_equal_jax():
    for args in ((48, 6), (48, 4), (1080, 12), (1080, 6)):
        for rgba in (False, True):
            for expanded in (False, True):
                assert (budget_mod.planes_bytes_per_lane(*args, rgba, expanded)
                        == jautobatch.planes_bytes_per_lane(*args, rgba, expanded))
        assert budget_mod.screen_bytes_per_lane(1920, 1080, True) == \
            jautobatch.screen_bytes_per_lane(1920, 1080, True)
    for budget in (10**3, 10**9, 80 * 10**9):
        assert (budget_mod.feasible_batch(7e6, 2e6, budget=budget)
                == jautobatch.feasible_batch(7e6, 2e6, budget=budget, quantum=1))
    # K6 writes no index table: twice the planes (the caller's and the
    # pose-major copy) and the screen
    assert budget_mod.posed_bytes_per_lane(1080, 6, 1920, 1080) == \
        2 * 6 * 1080 * 1080 + 1920 * 1080
    assert budget_mod.feasible_batch(1, 0, device="cpu") >= 1


# ------------------------------------------------------------------ Session


def _sessions(**kw):
    return JSession(W, H, platesize=S, **kw), Session(W, H, platesize=S, device="cpu")


@pytest.mark.parametrize("kind,k", [("u8", 1), ("u8", 2), ("expanded", 1), ("rgba", 1),
                                    ("rgba", 2)])
def test_session_render_posed_vs_jax_session(kind, k):
    js, ps = _sessions()
    frames = _source(kind)
    want = np.asarray(js.render_posed(frames, np.asarray(POSES), render_scale=k))
    got = ps.render_posed(frames, np.asarray(POSES), render_scale=k)
    assert got.shape == want.shape == (B, H, W)
    assert got.dtype == (torch.uint32 if kind == "rgba" else torch.uint8)
    print(f"{kind} k={k}: {int((_np(got) != want).sum())} of {want.size} pixels differ")
    assert _mismatch(_np(got), want) <= 0.02


@pytest.mark.parametrize("kind,k", [("u8", 1), ("u8", 2), ("expanded", 1), ("rgba", 2)])
def test_session_render_posed_exact_equals_jax(kind, k):
    """exact=True: float64 host builds per pose on both sides, bit for
    bit; a set background shows where no plate maps."""
    js, ps = _sessions()
    bg = np.random.default_rng(3).integers(0, 256, (H, W), dtype=np.uint8)
    js.set_background(bg)
    ps.set_background(bg)
    frames = _source(kind)
    want = np.asarray(js.render_posed(frames, np.asarray(POSES), render_scale=k, exact=True))
    got = ps.render_posed(frames, np.asarray(POSES), render_scale=k, exact=True)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("k", [1, 2])
def test_session_render_posed_forward_lens_equals_jax(kind, k):
    """eckert1, a forward-only lens: the Session's table is the host
    rasterization's texel centres (the session's static lensmap at k = 1,
    a rasterization at W/k with the zoom scale times k at k = 2), equal to
    the JAX package's build_ray_table; the screens equal the JAX package's
    NumPy float32 index math on that table bit for bit, and its jitted
    Session within CPU_FUZZ."""
    js, ps = _sessions()
    for s_ in (js, ps):
        s_.cmd("f_lens eckert1")
    frames = _source(kind)
    ps.render(frames[..., 0])  # a static build the k = 1 table may reuse
    got = ps.render_posed(frames, np.asarray(POSES), render_scale=k)
    table = ps._posed_cache[1].ray_table
    jt = jstatic.build_ray_table(js.lens, js.globe, ps._posed_scale[1] * k, W // k, H // k, S)
    assert table.source == jt.source == "lensmap"
    for f in ("vx", "vy", "vz", "lens_valid"):
        np.testing.assert_array_equal(getattr(table, f).numpy(), np.asarray(getattr(jt, f)))
    bg = ps._posed_background(kind == "rgba")  # zeros, decoded for RGBA
    np.testing.assert_array_equal(_np(got), _jax_numpy_f32_screens(kind, k, frames, bg,
                                                                   jg=js.globe, t=jt))
    want = np.asarray(js.render_posed(frames, np.asarray(POSES), render_scale=k))
    print(f"eckert1 {kind} k={k}: {int((_np(got) != want).sum())} of {want.size} pixels "
          "differ from the jitted JAX Session")
    assert _mismatch(_np(got), want) <= CPU_FUZZ


@pytest.mark.parametrize("kind,k", [("u8", 1), ("u8", 2), ("expanded", 1), ("rgba", 2)])
def test_session_render_posed_exact_forward_lens_equals_jax(kind, k):
    """exact=True with eckert1: one host rasterization per pose with the
    pose's basis on both sides, bit for bit."""
    js, ps = _sessions()
    for s_ in (js, ps):
        s_.cmd("f_lens eckert1")
    frames = _source(kind)
    want = np.asarray(js.render_posed(frames, np.asarray(POSES), render_scale=k, exact=True))
    got = ps.render_posed(frames, np.asarray(POSES), render_scale=k, exact=True)
    np.testing.assert_array_equal(_np(got), want)


def test_forward_lens_has_no_fused_posed_pipeline():
    """PosedRemapKernel and zoom_sweep_remap run the float32 lens stage,
    which a forward-only lens does not have: both packages refuse it."""
    jg, pg = jglobes.get("cube"), globes.get("cube")
    jl, pl = jlenses.get("eckert1", jg), lenses.get("eckert1", pg)
    scale = calc_scale(Zoom("contain"), pl, W, H)
    with pytest.raises(ValueError, match="forward-only"):
        jposed.PosedRemapKernel(jl, jg, W, H, scale, platesize=S)
    with pytest.raises(ValueError, match="forward-only"):
        posed.PosedRemapKernel(pl, pg, W, H, scale, platesize=S, device="cpu")
    with pytest.raises(ValueError, match="forward-only"):
        posed.zoom_sweep_remap(pl, pg, [scale, scale * 2], _source("u8")[..., 0], W, H,
                               device="cpu")


def test_render_posed_identity_near_static_render():
    """The identity pose resolves uv in float32 where the static render
    resolves it in float64, so texels whose sample lies on an edge may
    flip.  At this size many samples lie exactly on edges (the JAX
    package's own split is 10 % here); the port flips no more of them
    than the JAX package does."""
    js, ps = _sessions()
    frames = _source("u8")[..., :1]
    ident = np.zeros((1, 3))
    port = _mismatch(ps.render_posed(frames, ident)[0].numpy(), ps.render(frames)[..., 0].numpy())
    jax = _mismatch(np.asarray(js.render_posed(frames, ident))[0],
                    np.asarray(js.render(frames))[..., 0])
    print(f"identity pose against the static render: port {port}, JAX package {jax}")
    assert port <= jax


def test_render_posed_accepts_bases_and_tensors():
    _, ps = _sessions()
    frames = _source("rgba")
    want = ps.render_posed(frames, np.asarray(POSES))
    bases = posed.bases_from_pose_track(POSES)
    frames_t = _t(frames.view(np.int32)).view(torch.uint32)
    assert torch.equal(ps.render_posed(frames_t, bases), want)


def test_render_posed_rubix_rides_the_source():
    """The f_rubix flag is not consulted: the source's layout decides."""
    _, ps = _sessions()
    frames = _source("u8")
    off = ps.render_posed(frames, np.asarray(POSES))
    ps.cmd("f_rubix")
    assert ps.rubix_enabled
    assert torch.equal(ps.render_posed(frames, np.asarray(POSES)), off)
    tinted = ps.render_posed(_source("expanded", frames), np.asarray(POSES))
    assert not torch.equal(tinted, off)


def test_render_posed_background_and_palette_invalidate_cache():
    js, ps = _sessions()
    frames = _source("u8")
    first = ps.render_posed(frames, np.asarray(POSES))
    bg = np.full((H, W), 77, np.uint8)
    js.set_background(bg)
    ps.set_background(bg)
    second = ps.render_posed(frames, np.asarray(POSES))
    assert not torch.equal(first, second)
    assert _mismatch(_np(second), np.asarray(js.render_posed(frames, np.asarray(POSES)))) <= 0.02
    rgba = ps.render_posed(_source("rgba", frames), np.asarray(POSES))
    pal = default_palette().copy()
    pal[77] = (1, 2, 3)
    ps.palette = pal
    assert not torch.equal(ps.render_posed(frames_to_rgba(frames, pal), np.asarray(POSES)),
                           rgba)


def test_render_posed_empty_batch():
    js, ps = _sessions()
    for kind in ("u8", "rgba"):
        empty = _source(kind)[..., :0]
        got = ps.render_posed(empty, np.zeros((0, 3)))
        want = js.render_posed(empty, np.zeros((0, 3)))
        assert got.shape == want.shape == (0, H, W)
        assert got.dtype == (torch.uint32 if kind == "rgba" else torch.uint8)
        assert ps.render_posed(empty, np.zeros((0, 3)), render_scale="auto").shape == (0, H, W)
    with pytest.raises(ValueError, match="render_scale"):
        ps.render_posed(_source("u8")[..., :0], np.zeros((0, 3)), render_scale=5)


def test_render_posed_batch_mismatch_raises():
    _, ps = _sessions()
    two = _source("u8")[..., :2]
    for frames, poses in ((two, np.zeros((1, 3))), (two, np.zeros((3, 3))),
                          (two[..., :0], np.zeros((5, 3)))):
        with pytest.raises(ValueError, match="bases"):
            ps.render_posed(frames, poses)
    with pytest.raises(ValueError, match="frame batch"):
        ps.render_posed(two[..., 0], np.zeros((1, 3)))


def test_render_posed_needs_fisheye_and_a_lens():
    js, ps = _sessions()
    frames = _source("u8")
    for s in (js, ps):
        s.cmd("fisheye 0")
        with pytest.raises(ValueError, match="fisheye enabled"):
            s.render_posed(frames, np.asarray(POSES))
    js, ps = _sessions()
    for s in (js, ps):
        s.cmd("f_lens nosuch")
        with pytest.raises(ValueError, match="valid lens"):
            s.render_posed(frames, np.asarray(POSES))


def test_render_posed_chunks_under_a_tiny_budget(monkeypatch):
    """A budget that holds two poses splits the batch; the chunks
    together equal one call.  The budget is read once a key: a session
    that already planned this batch does not read it again."""
    _, ps = _sessions()
    frames = _source("expanded")
    whole = ps.render_posed(frames, np.asarray(POSES))
    lane = budget_mod.posed_bytes_per_lane(S, 12, W, H)
    calls, reads = [], []
    real = static_ray.static_ray_posed

    def counted(src, *a, **kw):
        calls.append(src.shape[0])
        return real(src, *a, **kw)

    def budget(device):
        reads.append(device)
        return 2 * lane + 1

    monkeypatch.setattr(budget_mod, "free_budget_bytes", budget)
    monkeypatch.setattr(static_ray, "static_ray_posed", counted)
    assert torch.equal(ps.render_posed(frames, np.asarray(POSES)), whole)
    assert calls == [5] and reads == []
    _, fresh = _sessions()
    assert torch.equal(fresh.render_posed(frames, np.asarray(POSES)), whole)
    assert calls == [5, 2, 2, 1] and len(reads) == 1


def test_render_posed_auto_render_scale():
    """render_scale="auto": an unlimited frame time picks native, an
    impossible one the largest valid k, each bit-equal to the explicit
    render_scale; the probes are cached."""
    _, ps = _sessions()
    frames = _source("u8")[..., :3]
    poses = np.stack([np.zeros(3), np.linspace(0, 40, 3), np.zeros(3)], 1)
    auto1 = ps.render_posed(frames, poses, render_scale="auto", target_fps=1e-6)
    assert torch.equal(auto1, ps.render_posed(frames, poses, render_scale=1))
    auto8 = ps.render_posed(frames, poses, render_scale="auto", target_fps=1e9)
    assert torch.equal(auto8, ps.render_posed(frames, poses, render_scale=8))
    key, probes = ps._auto_scale_probes
    assert len(probes) == 4 and probes[3] == 8 and all(t > 0 for t in probes[:3])
    again = ps.render_posed(frames, poses, render_scale="auto", target_fps=1e-6)
    assert ps._auto_scale_probes[1] is probes
    assert torch.equal(again, auto1)
    # the probes' tables landed in the stash for the real kernels
    assert set(ps._ray_tables[1]) >= {1, 8}


def _gate_native_table(monkeypatch, fail=False):
    """Hold the native-size ray-table build until released (or make it
    fail); coarser builds pass straight through."""
    real = static_ray.ray_table_from_lens
    state = {"release": threading.Event(), "started": [], "calls": []}

    def gated(lens, scale, w, h, *a, **kw):
        state["calls"].append((w, h))
        if (w, h) == (W, H):
            state["started"].append(time.monotonic())
            if fail:
                raise RuntimeError("table build exploded")
            assert state["release"].wait(30), "test deadlock"
        return real(lens, scale, w, h, *a, **kw)

    monkeypatch.setattr(static_ray, "ray_table_from_lens", gated)
    return state


def _drain(sess):
    deadline = time.time() + 30
    while sess.posed_pending and time.time() < deadline:
        time.sleep(0.01)
    assert not sess.posed_pending


def test_render_posed_nonblocking_preview_then_swap(monkeypatch):
    """block=False: the first call returns the coarse (k=4) preview while
    the native table builds on a thread; once it lands the next call
    serves the native screens, equal to a blocking session's."""
    gate = _gate_native_table(monkeypatch)
    _, ps = _sessions()
    frames = _source("u8")
    out = ps.render_posed(frames, np.asarray(POSES), block=False)
    assert out.shape == (B, H, W) and ps.posed_pending
    # count the calls once the build thread has made its own, which it may
    # make after the first call returns
    deadline = time.time() + 30
    while not gate["started"] and time.time() < deadline:
        time.sleep(0.01)
    assert gate["started"]
    n = len(gate["calls"])
    assert torch.equal(ps.render_posed(frames, np.asarray(POSES), block=False), out)
    assert len(gate["calls"]) == n  # the preview kernel is reused
    gate["release"].set()
    _drain(ps)
    swapped = ps.render_posed(frames, np.asarray(POSES), block=False)
    _, ref = _sessions()
    assert torch.equal(swapped, ref.render_posed(frames, np.asarray(POSES)))
    assert torch.equal(out, ref.render_posed(frames, np.asarray(POSES), render_scale=4))


def test_render_posed_nonblocking_single_async_slot(monkeypatch):
    """A zoom change while a build is in flight serves previews and starts
    no second build; the new key's build runs after the stale one."""
    gate = _gate_native_table(monkeypatch)
    _, ps = _sessions()
    frames = _source("u8")
    ps.render_posed(frames, np.asarray(POSES), block=False)
    deadline = time.time() + 10
    while not gate["started"] and time.time() < deadline:
        time.sleep(0.01)
    ps.cmd("f_fov 120")
    assert ps.render_posed(frames, np.asarray(POSES), block=False).shape == (B, H, W)
    time.sleep(0.2)
    assert len(gate["started"]) == 1 and ps.posed_pending
    gate["release"].set()
    _drain(ps)
    ps.render_posed(frames, np.asarray(POSES), block=False)  # kicks the new key
    _drain(ps)
    swapped = ps.render_posed(frames, np.asarray(POSES), block=False)
    _, ref = _sessions()
    ref.cmd("f_fov 120")
    assert torch.equal(swapped, ref.render_posed(frames, np.asarray(POSES)))


def test_render_posed_nonblocking_failed_build_sticks(monkeypatch):
    """A failed background build re-raises on the next call; after three
    failures on one key the error re-raises with no new build, and a key
    change starts over."""
    gate = _gate_native_table(monkeypatch, fail=True)
    _, ps = _sessions()
    frames = _source("u8")
    poses = np.asarray(POSES)
    for _ in range(3):
        assert ps.render_posed(frames, poses, block=False).shape == (B, H, W)
        _drain(ps)
        with pytest.raises(RuntimeError, match="exploded"):
            ps.render_posed(frames, poses, block=False)
    assert len(gate["started"]) == 3
    for _ in range(2):
        with pytest.raises(RuntimeError, match="exploded"):
            ps.render_posed(frames, poses, block=False)
    assert len(gate["started"]) == 3
    ps.cmd("f_fov 90")
    assert ps.render_posed(frames, poses, block=False).shape == (B, H, W)
    _drain(ps)
    assert len(gate["started"]) == 4


def test_render_posed_reuses_tables_across_kernels():
    """The ray-table stash: a second source kind at the same zoom builds
    no new table; a zoom change starts a new generation."""
    _, ps = _sessions()
    frames = _source("u8")
    ps.render_posed(frames, np.asarray(POSES))
    gen, tables = ps._ray_tables
    t1 = tables[1]
    ps.render_posed(_source("rgba", frames), np.asarray(POSES))
    assert ps._ray_tables[1][1] is t1
    ps.cmd("f_fov 120")
    ps.render_posed(frames, np.asarray(POSES))
    assert ps._ray_tables[0] != gen
    # the static lensmap (identity view, this zoom) is recorded as reusable
    ps.render(frames[..., :1])
    assert ps._reusable_static_lensmap(ps._lensmap.scale, S, 1) is ps._lensmap
    assert ps._reusable_static_lensmap(ps._lensmap.scale, S, 2) is None
