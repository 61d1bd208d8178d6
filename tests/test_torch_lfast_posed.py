"""The posed path on a user's Lua globe, ``lfast.lua`` (Blinky's two-plate
``fast.lua`` as the port's drop-in transcribes it), on the CPU: against
the benchmark's plain reference of that globe
(``benchmark/reference/globe_fastlua.py``), against the built-in ``fast``
globe's in-kernel resolver, and the Session's plan of the script's pieces.

The sizes are the benchmark's CPU sizes (a 64x48 screen, 48-pixel plates,
two planes a frame) at ``lfast.posed_card``'s configuration (panini at
``f_fov 160``) and the cell's first eight poses of a seed: the identity,
(89, 180, 0) beside the pole, and six drawn from the cell's ranges.  The
program's rays come from the float32 lens stage and the script meets them
in float32; the reference's rays come from the float64 lens stage and it
evaluates the script in float64.  So a pixel flips where its ray meets a
texel edge or the window between the plates.  Each lane's tolerance, the
largest share of its pixels that may differ:

* the identity, :data:`IDENTITY_TOL`: ``f_fov 160`` is the wide plate's
  span, so the screen's first column looks exactly along the plate's left
  edge (u = 0), and float32 and float64 rays fall either side of it: that
  column, 1/64 of the pixels here (1/1920 at 1080p), reads 0.0156;
* the view beside the pole, :data:`POLE_TOL`: it reads 0.0013-0.0016;
* the seeded lanes, :data:`SEEDED_TOL`: they read 0.

The tolerances are this file's, not the benchmark cell's limit.  The
reference one precision down must read above them in the lanes that see
a plate.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, poses
from benchmark.drivers import posed_script
from benchmark.reference import globe_fastlua
from blinky_tpu_torch import budget
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench import lua_drop_ins
from blinky_tpu_torch.globes.builtin import fast_resolver_torch
from blinky_tpu_torch.kernels import static_ray
from blinky_tpu_torch.lensmap.builder import plate_resolver_mode, rotate_rays, script_plates
from blinky_tpu_torch.lua_bridge import load_lua_globe

CELL = "lfast.posed_card"
_, CFG, _ = harness.resolve(harness.benchmark_spec(), CELL)
CFG = {**CFG, "width": 64, "height": 48, "platesize": 48}
B, SEED = 8, 2**31 + 29
IDENTITY_TOL, POLE_TOL, SEEDED_TOL = 0.02, 0.005, 0.002
TOLS = torch.tensor([IDENTITY_TOL, POLE_TOL] + [SEEDED_TOL] * (B - 2))


def _session(tmp_path, fov=CFG["fov"]):
    """The cell's Session at the CPU size, its globe the port's ``lfast.lua``
    drop-in found in a ``globe_dirs`` directory."""
    sess = Session(CFG["width"], CFG["height"], platesize=CFG["platesize"], device="cpu",
                   globe_dirs=[lua_drop_ins.write_scripts(tmp_path / "globes")])
    for line in ("fisheye 1", "f_globe lfast", f"f_lens {CFG['lens']}", f"f_fov {fov}"):
        sess.cmd(line)
    assert plate_resolver_mode(sess.globe) == "script"
    return sess


def _lanes(out, ref):
    """The share of each lane's pixels that differ, ``[B]``."""
    return (out != ref).reshape(out.shape[0], -1).double().mean(dim=1)


@pytest.fixture(scope="module")
def case():
    """The two-plate frames, the bases of the cell's first poses, the
    reference's screens."""
    frames = posed_script.frame_batches(2, CFG["platesize"], B, 1, SEED, "cpu")[0]
    bases = poses.bases(poses.tracks(SEED, 1, B, CFG)[0])
    return frames, bases, globe_fastlua.FastLuaPosed(CFG, "cpu")(frames, bases)


def test_the_cells_script_is_the_drop_in():
    assert CFG["script"] == lua_drop_ins.LFAST and CFG["globe"] == "lfast"
    assert CFG["planes"] == 2 and CFG["fov"] == 160


@pytest.mark.parametrize("given", ["bases", "bases_tensor"])
def test_render_posed_through_the_script_is_within_its_tolerances(case, given, tmp_path):
    frames, bases, expect = case
    poses_in = bases if given == "bases" else torch.as_tensor(bases, dtype=torch.float32)
    out = _session(tmp_path).render_posed(frames, poses_in)
    assert out.shape == (B, CFG["height"], CFG["width"]) and out.dtype == torch.uint8
    lanes = _lanes(out, expect)
    assert bool((lanes <= TOLS).all()), lanes
    # the identity's flips are the first column's: the wide plate's edge
    differ = (out[0] != expect[0]).nonzero()[:, 1].unique().tolist()
    assert differ in ([], [0]), differ


def test_the_control_reads_above_the_tolerances(case):
    """The reference one precision down (the script and the uv in float32,
    the rays in bfloat16) reads above the identity's and the pole's
    tolerances, and five times the seeded one in each seeded lane that shows
    a plate on a tenth of its pixels or more (a lane that looks away from
    the globe's front hemisphere shows the background alike on both
    sides)."""
    frames, bases, expect = case
    control = globe_fastlua.FastLuaPosed(CFG, "cpu", hi=torch.float32, lo=torch.bfloat16)
    lanes = _lanes(control(frames, torch.as_tensor(bases)), expect)
    seen = (expect != 0).reshape(B, -1).double().mean(dim=1) >= 0.1
    assert lanes[0] > IDENTITY_TOL and lanes[1] > POLE_TOL, lanes
    assert seen[2:].any() and (lanes[2:][seen[2:]] > 5 * SEEDED_TOL).all(), (lanes, seen)


def _neighbours_pose(bases):
    out = bases.copy()
    out[3:] = bases[2:-1]
    return out


def _transposed(bases):
    return np.swapaxes(bases, -1, -2).copy()


@pytest.mark.parametrize("fault", [_neighbours_pose, _transposed])
def test_a_planted_fault_reads_above_the_tolerances(case, fault, tmp_path):
    frames, bases, expect = case
    out = _session(tmp_path).render_posed(frames, fault(bases))
    assert not bool((_lanes(out, expect) <= TOLS).all())


def test_the_references_plate_is_the_scripts_in_double(tmp_path):
    """The reference's ``globe_plate`` in float64 gives the script's own
    plates, run by the Lua interpreter on the same double rays (its NumPy
    path), on random rays and on rays at the window's edges."""
    path_globe = load_lua_globe(lua_drop_ins.write_scripts(tmp_path) / "lfast.lua")
    rng = np.random.default_rng(11)
    x, y, z = rng.normal(size=(3, 4000))
    edge = np.tan(np.pi / 4)
    x[:200], z[:200] = edge * z[:200], np.abs(z[:200])  # on the window's side edges
    y[200:300] = 0.0
    z[300:350] = 0.0
    want = path_globe.plate_resolver(x, y, z, None)
    got = globe_fastlua.globe_plate(*(torch.from_numpy(a) for a in (x, y, z)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert set(np.unique(want).tolist()) == {-1, 0, 1}


def test_the_scripts_plates_equal_the_built_in_fast_resolver(tmp_path):
    """On the rays K13 gives the script (the ray table turned by each pose
    and normalized), the script's plates in tensor mode equal those of the
    built-in ``fast`` globe's float32 resolver, the one K6 runs in its fast
    mode, pixel for pixel."""
    sess = _session(tmp_path)
    frames = posed_script.frame_batches(2, CFG["platesize"], 64, 1, SEED, "cpu")[0]
    bases = torch.as_tensor(poses.bases(poses.tracks(SEED, 1, 64, CFG)[0]), dtype=torch.float32)
    sess.render_posed(frames, bases)
    table = sess._posed_cache[1].ray_table
    rays = rotate_rays(table.vx, table.vy, table.vz, bases)
    got = script_plates(sess.globe, *rays)
    want = fast_resolver_torch(*rays)
    assert torch.equal(got, want)
    assert set(got.unique().tolist()) == {-1, 0, 1}
    plates = static_ray.script_pose_plates(table, bases, sess.globe)
    assert torch.equal(plates, want.to(torch.int8))


class _Budget:
    """Free memory as the budget reads it: set by the test, each read
    counted."""

    def __init__(self, monkeypatch):
        self.free, self.reads = 0, 0
        monkeypatch.setattr(budget, "device_memory_bytes", self)

    def __call__(self, device):
        self.reads += 1
        return self.free

    def pieces_of(self, poses_a_piece):
        """Set the free memory so that a piece takes *poses_a_piece* poses
        of the CPU size's screen."""
        per_pose = budget.script_bytes_per_lane(CFG["width"] * CFG["height"])
        self.free = int(np.ceil(poses_a_piece * per_pose / budget.BUDGET_FRACTION))


def test_the_pieces_are_planned_once_a_key(monkeypatch, tmp_path):
    """The script's pieces are planned at a key's first call: free memory
    changed since is not read again for calls of that key at or below the
    planned batch, but it is for a larger batch and for a new key, and
    the plates do not depend on the pieces."""
    mem = _Budget(monkeypatch)
    sess = _session(tmp_path)
    frames = posed_script.frame_batches(2, CFG["platesize"], 12, 1, SEED, "cpu")[0]
    bases = torch.as_tensor(poses.bases(poses.tracks(SEED, 1, 12, CFG)[0]), dtype=torch.float32)

    def pieces(n):
        before = static_ray.script_pose_plates.pieces
        out = sess.render_posed(frames[..., :n], bases[:n])
        return static_ray.script_pose_plates.pieces - before, out

    mem.pieces_of(3)
    got, first = pieces(8)
    assert got == 3  # 3 + 3 + 2 poses
    mem.pieces_of(1)
    reads = mem.reads
    got, again = pieces(8)
    assert got == 3 and torch.equal(again, first)
    assert pieces(4)[0] == 2  # the plan of 3 poses a piece holds for a smaller batch
    assert mem.reads == reads  # nothing read: the key and the Session's cap are unchanged
    got, out12 = pieces(12)
    assert got == 12  # a batch above the plan reads again: 1 pose a piece now
    assert torch.equal(out12[:8], first)
    mem.pieces_of(4)
    sess.cmd("f_fov 150")  # a new key
    assert pieces(8)[0] == 2


def test_the_script_stage_and_its_pieces_are_spans(monkeypatch, tmp_path):
    """Under a profile each call's script stage is a ``posed.script_plates``
    span inside its ``session.render_posed``, holding one
    ``posed.script_piece`` span a piece, as many as the counter counts."""
    mem = _Budget(monkeypatch)
    mem.pieces_of(3)
    sess = _session(tmp_path)
    frames = posed_script.frame_batches(2, CFG["platesize"], B, 1, SEED, "cpu")[0]
    bases = torch.as_tensor(poses.bases(poses.tracks(SEED, 1, B, CFG)[0]), dtype=torch.float32)
    sess.render_posed(frames, bases)
    before = static_ray.script_pose_plates.pieces
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            sess.render_posed(frames, bases)
    assert static_ray.script_pose_plates.pieces - before == 6
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"])
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    calls = [s for s in spans if s[0] == "session.render_posed"]
    stages = [s for s in spans if s[0] == "posed.script_plates"]
    pieces = [s for s in spans if s[0] == "posed.script_piece"]
    assert len(calls) == len(stages) == 2 and len(pieces) == 6
    for (_, a, b), (_, s, e) in zip(calls, stages):
        assert a <= s and e <= b
        assert sum(s <= p and q <= e for _, p, q in pieces) == 3
