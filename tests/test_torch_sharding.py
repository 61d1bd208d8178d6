"""The port's mesh (blinky_tpu_torch.parallel and the sharded kernel
functions) against blinky_tpu's, test for test with tests/test_sharding.py.

The port's mesh here is ``[torch.device("cpu")] * 8``: eight logical shards
of the CPU, each cell's launches run one after another on the kernels'
plain versions.  The JAX side runs on the 8 virtual CPU devices
(tests/conftest.py).  Every output is held to the JAX package's sharded
output on the same seeded inputs and to the port's unsharded path:

* gathers and posed paths: tolerance 0 (both packages index the same exact
  float64 host lensmap, or the posed paths take the port's own ray table);
* the sharded float32 build: bit-equal to the port's unsharded float32
  build (the lens stage on a row block computes each pixel as the whole
  grid does), and held to the JAX package's sharded float32 build by the
  rule of tests/test_torch_lensmap.py, ``F32_SHARE`` = 0.15 of the pixels
  in ``flat_idx`` and ``px``/``py`` within one texel where both chose the
  same plate (torch's and XLA:CPU's lens stages differ in the last bits of
  their transcendentals, which flips boundary texels).

The JAX test of the no-collectives property reads the compiled HLO; the
port has no HLO, so its counterpart asserts what each cell holds: its own
row block of the remap operands and its own lanes of the frames, on its
own device.
"""

import jax
import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu import parallel as jparallel
from blinky_tpu.io.cubemap import synthetic_cubemap_batch
from blinky_tpu.kernels.remap import RemapKernel as JRemapKernel
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.palette import default_palette
from blinky_tpu_torch import globes, lenses, parallel
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.kernels.remap import (
    RemapKernel, expand_frames_tinted, frames_to_rgba,
)
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale

CPU8 = [torch.device("cpu")] * 8
F32_SHARE = 0.15
FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu()
        return x.view(torch.int32).numpy().view(np.uint32) if x.dtype == torch.uint32 \
            else x.numpy()
    return np.asarray(x)


def _setup(W=64, H=48, S=32, B=16, lens_name="panini", zoom=("fov", 180)):
    """(port kernel, JAX kernel, frames) on the exact host lensmap."""
    g, jg = globes.get("cube"), jglobes.get("cube")
    lens, jl = lenses.get(lens_name, g), jlenses.get(lens_name, jg)
    scale = calc_scale(Zoom(*zoom), lens, W, H)
    assert scale == jcalc(JZoom(*zoom), jl, W, H)
    lm = build_lensmap(lens, g, scale, W, H, S)
    jlm = jbuild(jl, jg, scale, W, H, S, backend="numpy")
    return (RemapKernel(lm, default_palette(), device="cpu"),
            JRemapKernel(jlm, default_palette()), synthetic_cubemap_batch(S, B))


def _jax_host_faces(jik, panos):
    """The JAX ingest's faces of every lane by its NumPy path
    (``EquirectIngest.host``), which rounds each float32 product and sum on
    its own, as the port's K10 and its plain version do.  Its jitted path
    lets XLA:CPU contract the blend: on full-range random panos at 24x48 ->
    32 it differs from the host path in 3 of 98,304 face words (one channel
    by one), so the port is held to the host path."""
    return np.stack([jik.host(panos[..., b]) for b in range(panos.shape[-1])], axis=-1)


def _meshes(n_data, n_space):
    return (parallel.make_mesh(n_data, n_space, devices=CPU8),
            jparallel.make_mesh(n_data=n_data, n_space=n_space))


@pytest.fixture(autouse=True)
def _eight_jax_devices():
    assert len(jax.devices()) >= 8, "tests/conftest.py gives JAX 8 CPU devices"


def test_data_parallel_matches_single():
    k, jk, frames = _setup()
    mesh, jmesh = _meshes(8, 1)
    out = parallel.remap_sharded(k, frames, mesh)
    assert isinstance(out, parallel.ShardedArray) and len(out.pieces) == 8
    np.testing.assert_array_equal(_np(out), _np(k(frames)))
    np.testing.assert_array_equal(_np(out), np.asarray(jparallel.remap_sharded(jk, frames, jmesh)))


def test_2d_mesh_matches_single():
    k, jk, frames = _setup()
    mesh, jmesh = _meshes(4, 2)
    out = _np(parallel.remap_sharded(k, frames, mesh, rubix=True))
    np.testing.assert_array_equal(out, _np(k(frames, rubix=True)))
    np.testing.assert_array_equal(
        out, np.asarray(jparallel.remap_sharded(jk, frames, jmesh, rubix=True)))


def test_graft_dryrun():
    """The counterpart of ``__graft_entry__.dryrun_multichip(8)``: every
    pipeline of the JAX dryrun over a (4, 2) mesh at its shapes, each held
    to the port's unsharded path and to the JAX dryrun's sharded output."""
    from blinky_tpu.kernels import ingest as jingest
    from blinky_tpu.kernels import posed as jposed
    from blinky_tpu_torch.kernels.ingest import EquirectIngest
    from blinky_tpu_torch.kernels.posed import PosedRemapKernel, bases_from_pose_track

    n_data, n_space = 4, 2
    W, H, S, B = 64, 32 * n_space, 32, 4 * n_data
    k, jk, frames = _setup(W, H, S, B)
    mesh, jmesh = _meshes(n_data, n_space)
    pal = default_palette()
    for src, kw in ((frames, dict(rubix=True)), (expand_frames_tinted(frames, pal),
                                                 dict(rubix=True)),
                    (frames_to_rgba(frames, pal), {})):
        out = _np(parallel.remap_sharded(k, src, mesh, **kw))
        np.testing.assert_array_equal(out, _np(k(src, **kw)))
        np.testing.assert_array_equal(out, np.asarray(jparallel.remap_sharded(jk, src, jmesh, **kw)))
    # a forward lens's host raster, remapped sharded
    kf, jkf, _ = _setup(W, H, S, B, "sinusoidal", ("contain",))
    np.testing.assert_array_equal(_np(parallel.remap_sharded(kf, frames, mesh)), _np(kf(frames)))
    # the pose axis split, at render scales 1 and 2
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = k.lensmap.scale
    poses = np.stack([np.linspace(-20, 20, B), np.linspace(0, 45, B), np.zeros(B)], axis=1)
    bases = bases_from_pose_track(poses)
    for rs in (1, 2):
        pk = PosedRemapKernel(lens, g, W, H, scale, platesize=S, render_scale=rs, device="cpu")
        np.testing.assert_array_equal(_np(parallel.posed_remap_sharded(pk, frames, bases, mesh)),
                                      _np(pk(frames, bases)))
    # the equirect ingest and the fused pano -> screen kernel
    rng = np.random.default_rng(0)
    panos = rng.integers(0, 2**32, (24, 48, B), dtype=np.uint64).astype(np.uint32)
    ik, jik = EquirectIngest(24, 48, S, device="cpu"), jingest.EquirectIngest(24, 48, S)
    faces = parallel.ingest_equirect_sharded(ik, panos, mesh)
    np.testing.assert_array_equal(_np(faces), _np(ik(panos)))
    np.testing.assert_array_equal(_np(faces), _jax_host_faces(jik, panos))
    np.testing.assert_array_equal(_np(parallel.remap_sharded(k, faces, mesh)),
                                  _np(k(_np(faces))))
    rk = RemapKernel(k.lensmap, pal, device="cpu")
    from blinky_tpu_torch.kernels.ingest import EquirectScreenKernel

    ek = EquirectScreenKernel(ik, rk)
    jek = jingest.EquirectScreenKernel(jik, JRemapKernel(jk.lensmap, pal))
    for rubix in (False, True):
        out = _np(parallel.equirect_screen_sharded(ek, panos, mesh, rubix=rubix))
        np.testing.assert_array_equal(out, _np(ek(panos, rubix=rubix)))
        # the JAX fused kernel's blend is jitted (see _jax_host_faces):
        # held where its faces agree with the host path's, i.e. to the
        # port's remap of the JAX host faces
        np.testing.assert_array_equal(out, _np(rk(_jax_host_faces(jik, panos), rubix=rubix)))
    assert jek.remap.lensmap.width_px == W
    assert jposed.posed_remap_sharded.__name__ == parallel.posed_remap_sharded.__name__


def test_graft_entry_jits():
    """The counterpart of ``__graft_entry__.entry()``: the flagship step
    (160x120, B = 8, rubix through the tint LUT) on the port equals the JAX
    step's output, unsharded and on the 8-shard mesh."""
    import __graft_entry__ as ge

    fn, args = ge.entry()
    want = np.asarray(jax.jit(fn)(*args))
    k, _, frames = _setup(160, 120, 120, 8)
    got = _np(k(frames, rubix=True))
    assert got.shape == (120, 160, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(parallel.remap_sharded(k, frames, parallel.make_mesh(8, 1, devices=CPU8),
                                   rubix=True)), want)


def test_sharded_expanded_and_rgba_paths():
    W, H, S, B = 64, 32, 32, 8
    k, jk, frames = _setup(W, H, S, B)
    mesh, jmesh = _meshes(4, 2)
    pal = default_palette()
    ex = expand_frames_tinted(frames, pal)
    out = _np(parallel.remap_sharded(k, ex, mesh, rubix=True))
    np.testing.assert_array_equal(out, _np(k(ex, rubix=True)))
    np.testing.assert_array_equal(
        out, np.asarray(jparallel.remap_sharded(jk, ex, jmesh, rubix=True)))
    # the decode after the expanded gather (K2), JAX's jnp.take of rgb_lut
    dec = _np(parallel.remap_sharded(k, ex, mesh, rubix=True, decode_rgb=True))
    assert dec.shape == (H, W, B, 3)
    np.testing.assert_array_equal(
        dec, np.asarray(jparallel.remap_sharded(jk, ex, jmesh, rubix=True, decode_rgb=True)))
    rgba = frames_to_rgba(frames, pal)
    out2 = parallel.remap_sharded(RemapKernel(k.lensmap, pal, device="cpu"), rgba, mesh)
    assert out2.dtype == torch.uint32 and _np(out2).dtype == np.uint32
    np.testing.assert_array_equal(_np(out2), _np(k(rgba)))
    np.testing.assert_array_equal(_np(out2), np.asarray(jparallel.remap_sharded(jk, rgba, jmesh)))
    with pytest.raises(ValueError, match="expanded layout"):
        parallel.remap_sharded(k, rgba, mesh, rubix=True)


def test_remap_sharded_does_not_mutate_caller_kernel():
    k, _, frames = _setup()
    before = _np(k(frames))
    ops = {n: getattr(k, n).clone() for n in ("flat_idx", "valid", "tint", "background")}
    mesh, _ = _meshes(4, 2)
    out = parallel.remap_sharded(k, frames, mesh)
    for n, t in ops.items():
        got = getattr(k, n)
        assert got.shape == t.shape and torch.equal(got, t), n
    assert k.height_px == 48 and k.flat_idx.numel() == 48 * 64
    np.testing.assert_array_equal(_np(k(frames)), before)
    np.testing.assert_array_equal(_np(out), before)


def test_sharded_builder_matches_unsharded():
    W, H, S = 64, 48, 32
    g, jg = globes.get("cube"), jglobes.get("cube")
    lens, jl = lenses.get("stereographic", g), jlenses.get("stereographic", jg)
    scale = calc_scale(Zoom("fov", 300), lens, W, H)
    mesh, jmesh = _meshes(4, 2)
    lm_sh = parallel.build_lensmap_sharded(lens, g, scale, W, H, mesh, platesize=S)
    lm = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(lm_sh, f)), _np(getattr(lm, f)), err_msg=f)
    # two row blocks, each on the cells of its column
    assert {idx[0] for idx, _ in lm_sh.flat_idx.pieces} == {slice(0, 24), slice(24, 48)}
    jlm = jparallel.build_lensmap_sharded(jl, jg, scale, W, H, jmesh, platesize=S)
    got, want = lm_sh, jlm
    share = float((_np(got.flat_idx) != np.asarray(want.flat_idx)).mean())
    print(f"sharded float32 build: {share:.4f} of the pixels differ from JAX's")
    assert share <= F32_SHARE
    same = _np(got.valid) & np.asarray(want.valid) & (_np(got.plate) == np.asarray(want.plate))
    for f in ("px", "py"):
        assert np.abs(_np(getattr(got, f)) - np.asarray(getattr(want, f)))[same].max(
            initial=0) <= 1, f
    np.testing.assert_array_equal(_np(got.plates_used), np.asarray(want.plates_used))
    # the sharded tables feed remap_sharded directly
    frames = synthetic_cubemap_batch(S, 16)
    k = RemapKernel(lm_sh, default_palette(), device="cpu")
    ref = _np(RemapKernel(lm.to_numpy(), default_palette(), device="cpu")(frames, rubix=True))
    np.testing.assert_array_equal(_np(parallel.remap_sharded(k, frames, mesh, rubix=True)), ref)
    with pytest.raises(ValueError, match="inverse lenses"):
        parallel.build_lensmap_sharded(lenses.get("eckert1", g), g, scale, W, H, mesh)


def test_sharded_rgba_and_forward_lens():
    k, jk, frames = _setup()
    mesh, jmesh = _meshes(4, 2)
    rgba = frames_to_rgba(frames, default_palette())
    out = _np(parallel.remap_sharded(k, rgba, mesh))
    np.testing.assert_array_equal(out, _np(k(rgba)))
    np.testing.assert_array_equal(out, np.asarray(jparallel.remap_sharded(jk, rgba, jmesh)))
    kf, jkf, _ = _setup(lens_name="sinusoidal", zoom=("contain",))
    out_f = _np(parallel.remap_sharded(kf, frames, mesh))
    np.testing.assert_array_equal(out_f, _np(kf(frames)))
    np.testing.assert_array_equal(out_f, np.asarray(jparallel.remap_sharded(jkf, frames, jmesh)))


def test_posed_remap_sharded_matches_single_device():
    from blinky_tpu_torch.kernels.posed import PosedRemapKernel, bases_from_pose_track

    W, H, S, B = 64, 48, 32, 8
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    frames = synthetic_cubemap_batch(S, B)
    poses = np.stack([np.linspace(-30, 30, B), np.linspace(0, 90, B), np.zeros(B)], axis=1)
    bases = bases_from_pose_track(poses)
    k = PosedRemapKernel(lens, g, W, H, scale, platesize=S, device="cpu")
    ref = _np(k(frames, bases))
    mesh, _ = _meshes(8, 1)
    out = parallel.posed_remap_sharded(k, frames, bases, mesh)
    assert len(out.pieces) == 8 and out.shape == (B, H, W)
    np.testing.assert_array_equal(_np(out), ref)
    # each device ran the lens stage once: its copy's ray table, cached
    cached = k._sharded_for
    assert cached[0] is mesh and list(cached[1]) == [torch.device("cpu")]
    parallel.posed_remap_sharded(k, frames, bases, mesh)
    assert k._sharded_for is cached


def test_equirect_ingest_sharded():
    from blinky_tpu.kernels.ingest import EquirectIngest as JEquirectIngest
    from blinky_tpu_torch.kernels.ingest import EquirectIngest

    mesh, jmesh = _meshes(8, 1)
    rng = np.random.default_rng(6)
    H, W, B = 16, 32, 8
    panos = rng.integers(0, 2**32, (H, W, B), dtype=np.uint64).astype(np.uint32)
    kern = EquirectIngest(H, W, 12, device="cpu")
    shard = parallel.ingest_equirect_sharded(kern, panos, mesh)
    np.testing.assert_array_equal(_np(shard), _np(kern(panos)))
    jkern = JEquirectIngest(H, W, 12)
    jshard = jparallel.ingest_equirect_sharded(jkern, panos, jmesh)
    assert len(jshard.sharding.device_set) > 1
    np.testing.assert_array_equal(_np(shard), _jax_host_faces(jkern, panos))
    # distributed over the data shards: one lane block a piece
    assert sorted(idx[-1].start for idx, _ in shard.pieces) == list(range(8))


def test_sharded_builder_accepts_lua_lens(tmp_path):
    """A .lua lens goes through the row-split device build like the
    built-in it transcribes.  The JAX test reads the reference's shipped
    stereographic.lua, which is not in this repository; this one writes
    its own small stereographic .lua and holds its sharded build to the
    built-in lens's sharded build and to its own unsharded build."""
    from blinky_tpu_torch.lua_bridge import load_lua_lens

    W, H, S = 64, 48, 32
    g = globes.get("cube")
    path = tmp_path / "stereo.lua"
    path.write_text(
        "max_fov = 360\nmax_vfov = 360\n"
        "function lens_inverse(x, y)\n"
        "  local r = math.sqrt(x*x + y*y)\n"
        "  local theta = 2*math.atan(r/2)\n"
        "  local s = math.sin(theta)\n"
        "  local c = math.cos(theta)\n"
        "  if r == 0 then return 0, 0, 1 end\n"
        "  return x/r*s, y/r*s, c\n"
        "end\n"
        "function lens_forward(x, y, z)\n"
        "  local theta = math.acos(z / math.sqrt(x*x + y*y + z*z))\n"
        "  local r = 2*math.tan(theta/2)\n"
        "  local c = math.sqrt(x*x + y*y)\n"
        "  if c == 0 then return 0, 0 end\n"
        "  return x/c*r, y/c*r\n"
        "end\n")
    lua = load_lua_lens(str(path), g)
    assert lua.jittable
    scale = calc_scale(Zoom("fov", 200), lua, W, H)
    mesh, _ = _meshes(4, 2)
    lm_sh = parallel.build_lensmap_sharded(lua, g, scale, W, H, mesh, platesize=S)
    lm = build_lensmap(lua, g, scale, W, H, S, backend="torch", device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(lm_sh, f)), _np(getattr(lm, f)), err_msg=f)
    assert _np(lm_sh.valid).any()


def test_remap_sharded_requires_palette_for_luts():
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom("fov", 180), lens, 64, 48), 64, 48)
    k = RemapKernel(lm, device="cpu")  # no palette
    frames = np.repeat(synthetic_cubemap(48)[..., None], 8, axis=-1)
    mesh, _ = _meshes(4, 2)
    with pytest.raises(ValueError, match="palette"):
        parallel.remap_sharded(k, frames, mesh, decode_rgb=True)
    with pytest.raises(ValueError, match="palette"):
        parallel.remap_sharded(k, frames, mesh, rubix=True)
    with pytest.raises(ValueError, match="palette"):
        parallel.remap_sharded(k, expand_frames_tinted(frames, default_palette()), mesh,
                               decode_rgb=True)


def test_remap_sharded_caches_sharded_kernel():
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom("fov", 180), lens, 64, 48), 64, 48)
    k = RemapKernel(lm, default_palette(), device="cpu")
    frames = np.repeat(synthetic_cubemap(48)[..., None], 8, axis=-1)
    mesh, _ = _meshes(4, 2)
    out1 = _np(parallel.remap_sharded(k, frames, mesh))
    cached = k._sharded_for
    assert cached[0] is mesh
    out2 = _np(parallel.remap_sharded(k, frames, mesh))
    assert k._sharded_for is cached  # reused, not rebuilt
    np.testing.assert_array_equal(out1, out2)
    # another mesh makes new copies
    parallel.remap_sharded(k, frames, _meshes(8, 1)[0])
    assert k._sharded_for is not cached


def test_session_render_sharded_matches_render():
    from blinky_tpu.api import Session as JSession
    from blinky_tpu_torch.api import Session

    frames = synthetic_cubemap_batch(32, 16)
    sess = Session(64, 48, platesize=32, device="cpu")
    jsess = JSession(64, 48, platesize=32)
    for s in (sess, jsess):
        s.cmd("f_lens panini; f_fov 180")
    ref = _np(sess.render(frames))
    mesh, jmesh = _meshes(4, 2)
    mesh2 = parallel.make_slice_mesh(2, 2, 2, devices=CPU8)
    for m, jm in ((mesh, jmesh), (mesh2, jparallel.make_slice_mesh(2, 2, 2))):
        out = _np(sess.render_sharded(frames, m))
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, np.asarray(jsess.render_sharded(frames, jm)))
    for s in (sess, jsess):
        s.cmd("f_rubix 1")
    np.testing.assert_array_equal(_np(sess.render_sharded(frames, mesh)),
                                  _np(sess.render(frames)))
    np.testing.assert_array_equal(_np(sess.render_sharded(frames, mesh)),
                                  np.asarray(jsess.render_sharded(frames, jmesh)))
    sess.cmd("f_rubix 0")
    rgba = frames_to_rgba(frames, sess.palette)
    np.testing.assert_array_equal(_np(sess.render_sharded(rgba, mesh)), _np(sess.render(rgba)))
    # the checks: fisheye off raises; a pending sliced build finishes first
    sess.cmd("fisheye 0")
    with pytest.raises(ValueError, match="fisheye enabled"):
        sess.render_sharded(frames, mesh)
    sliced = Session(64, 48, platesize=32, device="cpu", build_budget_s=1e-6)
    sliced.cmd("f_lens winkeltripel")
    sliced.render(frames[..., :1])
    assert sliced.build_progress is not None
    exact = Session(64, 48, platesize=32, device="cpu")
    exact.cmd("f_lens winkeltripel")
    np.testing.assert_array_equal(_np(sliced.render_sharded(frames, mesh)),
                                  _np(exact.render(frames)))
    assert sliced.build_progress is None


def test_two_level_slice_mesh_pipelines_match_single_device():
    from blinky_tpu_torch.kernels.posed import PosedRemapKernel, bases_from_pose_track
    from blinky_tpu_torch.kernels.static_ray import StaticRayPosedKernel

    kernel, _, frames = _setup(B=8)
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, 64, 48)
    mesh = parallel.make_slice_mesh(2, 2, 2, devices=CPU8)
    assert parallel.data_axes(mesh) == ("slice", "data")
    assert mesh.shape == {"slice": 2, "data": 2, "space": 2} and mesh.devices.size == 8
    ref = _np(kernel(frames))
    copies = parallel.shard_kernel(kernel, mesh)
    sframes = parallel.shard_frames(frames, mesh)
    assert copies.shape == (2, 2, 2)
    # what no collective means here: each cell holds its own rows of the
    # operands and its own lanes of the frames, on its own device, and its
    # gather alone gives its block of the screen
    for (i, j, s), k in np.ndenumerate(copies):
        r0, r1 = (0, 24) if s == 0 else (24, 48)
        g_idx = 2 * i + j
        assert k.height_px == r1 - r0 and k.device == mesh.devices[i, j, s]
        np.testing.assert_array_equal(_np(k.flat_idx), kernel.lensmap.flat_idx[r0:r1].reshape(-1))
        part = sframes.piece((slice(0, 6), slice(0, 32), slice(0, 32),
                              slice(2 * g_idx, 2 * g_idx + 2)), k.device)
        assert part is not None and part.is_contiguous() and part.shape[-1] == 2
        np.testing.assert_array_equal(_np(k(part)), ref[r0:r1, :, 2 * g_idx:2 * g_idx + 2])
    out = _np(parallel.remap_sharded(kernel, frames, mesh))
    np.testing.assert_array_equal(out, ref)
    # the posed pipelines: the pose axis over slice x data
    bases = bases_from_pose_track(
        [(0, 0, 0), (5, -12, 0), (-20, 33, 10), (0, 271, -45),
         (1, 2, 3), (10, 20, 30), (-5, 5, -5), (0, 180, 0)])
    pk = PosedRemapKernel(lens, g, 64, 48, scale, platesize=32, device="cpu")
    np.testing.assert_array_equal(_np(parallel.posed_remap_sharded(pk, frames, bases, mesh)),
                                  _np(pk(frames, bases)))
    srk = StaticRayPosedKernel(lens, g, 64, 48, scale, platesize=32, device="cpu")
    np.testing.assert_array_equal(_np(parallel.static_ray_posed_sharded(srk, frames, bases, mesh)),
                                  _np(srk(frames, bases)))


def test_feasible_batch_mesh_aware():
    from blinky_tpu.bench.autobatch import feasible_batch as jfeasible
    from blinky_tpu_torch.bench.autobatch import QUANTUM
    from blinky_tpu_torch.budget import feasible_batch

    kw = dict(budget=16.2e9, quantum=QUANTUM)
    b1 = feasible_batch(3.77e6, 0, **kw)
    assert b1 == 4224 == jfeasible(3.77e6, 0, budget=16.2e9)
    assert feasible_batch(3.77e6, 0, n_devices=4, **kw) == 4 * b1
    for n, cap in ((4, 1000), (3, 1000), (8, 4)):
        assert feasible_batch(3.77e6, 0, n_devices=n, cap=cap, **kw) == jfeasible(
            3.77e6, 0, budget=16.2e9, n_devices=n, cap=cap)
    assert feasible_batch(3.77e6, 0, n_devices=3, cap=1000, **kw) == 999


def test_sharded_scaling_derives_batches():
    from blinky_tpu_torch.bench.throughput import (
        run_posed_sharded_scaling, run_sharded_scaling,
    )

    out = run_sharded_scaling(width=64, height=48, platesize=32, per_device_batch=None,
                              iters=1, reps=1, budget=50e6, devices=CPU8)
    assert len(out) >= 3
    for row in out:
        assert row["batch"] > 0 and row["equal"] and row["fps"] > 0
    assert [r["devices"] for r in out] == [1, 2, 4, 8]
    assert [r["mesh"] for r in out] == ["1x1", "2x1", "2x2", "4x2"]
    assert out[-1]["batch"] > out[0]["batch"]  # weak scaling: the batch grows
    posed = run_posed_sharded_scaling(width=64, height=48, platesize=32,
                                      per_device_poses=2, iters=1, reps=1,
                                      devices=CPU8[:4])
    assert [r["poses"] for r in posed] == [2, 4, 8] and all(r["equal"] for r in posed)


def test_make_mesh_devices():
    """A mesh needs its devices named when there is no card, takes
    repeats as logical shards, and refuses more cells than devices."""
    with pytest.raises(ValueError, match="need 9 devices"):
        parallel.make_mesh(9, 1, devices=CPU8)
    m = parallel.make_mesh(devices=CPU8)
    assert m.shape == {"data": 8, "space": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh(2, 1)
    assert parallel.visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="split evenly"):
        parallel.shard_frames(synthetic_cubemap_batch(16, 6), parallel.make_mesh(4, 1, devices=CPU8))
