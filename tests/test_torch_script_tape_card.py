"""K14 on a card: a script globe's plate resolver as one kernel, against the
evaluator's tensor mode on the same rays, byte for byte.

Every test here needs an NVIDIA GPU and skips without one; the file
imports no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_script_tape_card.py

The scripts are ``tests/test_torch_script_tape.py``'s: the port's
``lfast.lua`` at ``lfast.posed_card``'s lens, zoom and screen, and the
odd, max-dot, number-dividing and ``%`` resolvers on odd rays.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench import lua_drop_ins
from blinky_tpu_torch.kernels import _build, posed, script_tape, static_ray
from blinky_tpu_torch.lensmap.builder import rotate_rays
from test_torch_script_tape import TAPEABLE, _evaluator, _globe, _rays


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K14 builds and runs only there")
    return torch.device("cuda")


def _lfast_session(device, tmp_path, W=1920, H=1080):
    """A Session at ``lfast.posed_card``'s lens and zoom (panini, f_fov 160)
    on the port's lfast.lua drop-in, found through ``globe_dirs``."""
    sess = Session(W, H, platesize=min(W, H), device=device,
                   globe_dirs=[lua_drop_ins.write_scripts(tmp_path / "globes")])
    for line in ("fisheye 1", "f_globe lfast", "f_lens panini", "f_fov 160"):
        sess.cmd(line)
    return sess


def _bases(B, device, seed=30):
    """The identity, the view beside the pole, then seeded poses in the
    cell's ranges, as float32 ``[B, 3, 3]`` bases on *device*."""
    rng = np.random.default_rng(seed)
    poses = np.stack([rng.uniform(-60, 60, B), rng.uniform(0, 360, B),
                      rng.uniform(-30, 30, B)], 1)
    poses[0], poses[1] = (0.0, 0.0, 0.0), (89.0, 180.0, 0.0)
    return torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(device)


def _frames(B, S, device, seed=31):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (2, S, S, B), generator=g, dtype=torch.uint8, device=device)


def _kernel(sess, device, S=1080):
    """The Session's posed kernel, built by a call of two poses."""
    sess.render_posed(_frames(2, S, device), _bases(2, device))
    return sess._posed_cache[1]


@pytest.mark.cuda
def test_k14_plates_equal_the_evaluators_at_1080p(cuda_device, tmp_path):
    """lfast at 1080p on 64 poses (the identity, the pole view and 62
    seeded ones): K14's plates are the evaluator's, byte for byte."""
    sess = _lfast_session(cuda_device, tmp_path)
    kernel = _kernel(sess, cuda_device)
    assert script_tape.tape_of(sess.globe, cuda_device) is not None
    bases = _bases(64, cuda_device)
    n0, p0 = script_tape.script_tape.launches, static_ray.script_pose_plates.tape_pieces
    got = static_ray.script_pose_plates(kernel.ray_table, bases, sess.globe)
    assert script_tape.script_tape.launches > n0
    assert static_ray.script_pose_plates.tape_pieces > p0
    t = kernel.ray_table
    want = torch.cat([_evaluator(sess.globe, *rotate_rays(t.vx, t.vy, t.vz, bases[lo:lo + 16]))
                      for lo in range(0, 64, 16)])
    assert torch.equal(got, want)
    assert set(got.unique().tolist()) == {-1, 0, 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TAPEABLE))
def test_k14_equals_the_evaluator_on_odd_rays(cuda_device, name, tmp_path):
    """Each tapeable script on the card: dense rays (a run of four a thread
    and a short last run), the plates' edges, NaN and infinite rays, and a
    view off 16 bytes (a ray at a time); a division by a number is the
    card's product by the reciprocal."""
    g = _globe(tmp_path, name, TAPEABLE[name])
    tape = script_tape.record(script_tape.plates_fn(g), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    dense = [torch.randn(1_000_003, generator=gen, device=cuda_device) for _ in range(3)]
    cases = [tuple(t.to(cuda_device) for t in _rays(kind)) for kind in ("dense", "edges", "odd")]
    cases += [dense, [t[1:] for t in dense]]
    for x, y, z in cases:
        want = _evaluator(g, x, y, z)
        out = torch.full_like(want, 99)
        script_tape.script_tape(tape, x, y, z, out)
        assert torch.equal(out, want), (name, x.shape, (out != want).sum().item())


@pytest.mark.cuda
def test_render_posed_is_the_same_with_the_tape_and_the_evaluator(cuda_device, tmp_path,
                                                                  monkeypatch):
    """The screens of ``f_globe lfast`` with K14 and with the evaluator, as
    a script that does not record takes it."""
    sess = _lfast_session(cuda_device, tmp_path, 640, 360)
    _kernel(sess, cuda_device, 360)
    frames, bases = _frames(16, 360, cuda_device, 5), _bases(16, cuda_device, 5)
    p0 = static_ray.script_pose_plates.tape_pieces
    got = sess.render_posed(frames, bases)
    assert static_ray.script_pose_plates.tape_pieces > p0
    monkeypatch.setattr(static_ray, "tape_of", lambda globe, device: None)
    p0 = static_ray.script_pose_plates.tape_pieces
    want = sess.render_posed(frames, bases)
    assert static_ray.script_pose_plates.tape_pieces == p0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_each_piece_launches_k14_once_at_the_cells_shape(cuda_device, tmp_path):
    """At ``lfast.posed_card``'s shape (1080p, B = 1024, two-plate frames)
    every piece of a call is K14's: ``tape_pieces`` counts each piece, and
    each ``posed.script_piece`` span holds one ``launch.rotate_rays`` and
    one ``launch.script_tape``."""
    sess = _lfast_session(cuda_device, tmp_path)
    frames, bases = _frames(1024, 1080, cuda_device), _bases(1024, cuda_device)
    sess.render_posed(frames, bases)
    p0, t0 = static_ray.script_pose_plates.pieces, static_ray.script_pose_plates.tape_pieces
    k0 = script_tape.script_tape.launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess.render_posed(frames, bases)
        torch.cuda.synchronize()
    pieces = static_ray.script_pose_plates.pieces - p0
    assert pieces > 1
    assert static_ray.script_pose_plates.tape_pieces - t0 == pieces
    assert script_tape.script_tape.launches - k0 == pieces
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    found = [s for s in spans if s[0] == "posed.script_piece"]
    assert len(found) == pieces
    for _, s, e in found:
        for name in ("launch.rotate_rays", "launch.script_tape"):
            assert sum(n == name and s <= a and b <= e for n, a, b in spans) == 1, name


@pytest.mark.cuda
def test_the_library_is_rebuilt_only_when_the_script_changes(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(script_tape, "_libs", {})
    g = _globe(tmp_path, "lfast", lua_drop_ins.LFAST)
    tape = script_tape.record(script_tape.plates_fn(g), cuda_device)
    b0 = script_tape.library_for.builds
    lib = script_tape.library_for(tape)
    assert script_tape.library_for.builds == b0 + 1
    assert script_tape.library_for(script_tape.record(script_tape.plates_fn(g),
                                                      cuda_device)) is lib
    monkeypatch.setattr(script_tape, "_libs", {})  # another process, the same checkout
    script_tape.library_for(tape)
    assert script_tape.library_for.builds == b0 + 1
    changed = _globe(tmp_path, "lfast72", lua_drop_ins.LFAST.replace(
        "math.tan(math.pi / 4)", "math.tan(math.pi / 5)"))
    other = script_tape.record(script_tape.plates_fn(changed), cuda_device)
    script_tape.library_for(other)
    assert script_tape.library_for.builds == b0 + 2
    x, y, z = (t.contiguous() for t in torch.randn((3, 4096), device=cuda_device))
    out = torch.empty(x.shape, dtype=torch.int8, device=cuda_device)
    assert torch.equal(script_tape.script_tape(other, x, y, z, out), _evaluator(changed, x, y, z))
    assert not torch.equal(out, _evaluator(g, x, y, z))
