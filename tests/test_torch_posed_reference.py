"""``Session.render_posed`` against the benchmark's plain reference of the
posed path (``benchmark/reference/posed.py``), on the CPU, where the
session runs K6's plain version (``static_ray_posed_plain``).

The sizes are the benchmark's CPU sizes (a 64x48 screen, 48-pixel plates)
and the cell's first eight poses of a seed: the identity, (89, 180, 0)
beside the pole, and six drawn from the cell's ranges.  The program's ray
table comes from the float32 lens stage and the reference's from the
float64 one, so texels flip where a ray meets a texel edge.  The seeded
poses meet few edges and are held to a share of their own,
:data:`SEEDED_TOL` (they read 0 at this size, about 7e-5 at 1080p); the two
views aligned with the cube or its pole meet many (about 9.4 % and 0.85 % of
the pixels at this size) and have bounds of their own, and the exact path
holds every lane to :data:`SEEDED_TOL`.  The tolerances are this file's,
not the benchmark cell's limit.  The reference one precision down, and two
planted faults, must read above them.
"""

import numpy as np
import pytest
import torch

from benchmark import harness, poses, program, sources
from benchmark.reference import lensmap as ref_lensmap
from benchmark.reference import posed as ref_posed
from benchmark.reference import remap as ref_remap
from blinky_tpu_torch.kernels.posed import bases_from_pose_track

CELL = "pc1080.posed_card"
_, CFG, _ = harness.resolve(harness.benchmark_spec(), CELL)
CFG = {**CFG, "width": 64, "height": 48, "platesize": 48}
B, SEED = 8, 2**31 + 29
EPS = np.finfo(np.float64).eps
# the largest share of a lane's pixels that may differ from the reference:
# the identity (lane 0), the view beside the pole (lane 1), the seeded rest
IDENTITY_TOL, POLE_TOL, SEEDED_TOL = 0.1, 0.02, 0.002
TOLS = torch.tensor([IDENTITY_TOL, POLE_TOL] + [SEEDED_TOL] * (B - 2))


def _lanes(out, ref):
    """The share of each lane's pixels that differ, ``[B]``."""
    return (out != ref).reshape(out.shape[0], -1).double().mean(dim=1)


def _within(out, ref, tols=TOLS):
    return bool((_lanes(out, ref) <= tols).all())


@pytest.fixture(scope="module")
def case():
    """The frames, the pose track and its bases, the reference's screens."""
    frames = sources.cubemap_batches(CFG["platesize"], B, 1, SEED, "cpu")[0]
    track = poses.tracks(SEED, 1, B, CFG)[0]
    bases = poses.bases(track)
    expect = ref_posed.Posed(CFG, "cpu")(frames, bases)
    return frames, track, bases, expect


def _tracks():
    cell = [t for seed in (1, 2**33 + 5) for t in poses.tracks(seed, 2, 64, CFG)]
    rng = np.random.default_rng(7)
    poles = np.stack([np.repeat([90.0, -90.0, 89.999, -89.999], 8),
                      rng.uniform(0, 360, 32), rng.uniform(-30, 30, 32)], axis=1)
    return {"cell_ranges": np.concatenate(cell), "poles": poles}


@pytest.mark.parametrize("name", ["cell_ranges", "poles"])
def test_pose_bases_equal_the_programs_to_float64_rounding(name):
    track = _tracks()[name]
    mine, theirs = poses.bases(track), bases_from_pose_track(track)
    assert mine.shape == theirs.shape == (len(track), 3, 3) and mine.dtype == np.float64
    np.testing.assert_allclose(mine, theirs, rtol=0, atol=4 * EPS)


def test_pose_tracks_are_a_function_of_the_seed():
    a, b = poses.tracks(SEED, 2, 16, CFG), poses.tracks(SEED, 2, 16, CFG)
    c = poses.tracks(SEED + 1, 2, 16, CFG)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0][2:], c[0][2:]) and not np.array_equal(a[0], a[1])
    assert np.array_equal(a[0][:2], poses.FIRST) and np.array_equal(c[0][:2], poses.FIRST)
    whole = np.concatenate([a[0][2:], a[1]])
    for col, key in enumerate(("pose_pitch", "pose_yaw", "pose_roll")):
        lo, hi = CFG[key]
        assert (lo <= whole[:, col]).all() and (whole[:, col] < hi).all()


def test_identity_pose_is_the_static_reference(case):
    """At the identity the rotation is exact, so the reference is the static
    reference's lensmap and gather, texel for texel."""
    frames = case[0]
    out = ref_posed.Posed(CFG, "cpu")(frames, np.tile(np.eye(3)[[2, 0, 1]], (B, 1, 1)))
    c = CFG
    flat, valid = ref_lensmap.build(c["lens"], c["globe"], c["fov"], c["width"], c["height"],
                                    c["platesize"])
    static = ref_remap.gather(frames.reshape(-1, B), flat, valid, 0)
    assert torch.equal(out.reshape(B, -1).t(), static)


@pytest.mark.parametrize("given", ["bases", "bases_tensor", "angles"])
def test_render_posed_is_within_its_tolerances(case, given):
    frames, track, bases, expect = case
    poses = {"bases": bases, "angles": track,
             "bases_tensor": torch.as_tensor(bases, dtype=torch.float32)}[given]
    sess = program.session(CFG, "cpu")
    out = sess.render_posed(frames, poses, render_scale=CFG["render_scale"],
                            exact=CFG["exact"])
    assert out.shape == (B, CFG["height"], CFG["width"]) and out.dtype == torch.uint8
    assert _within(out, expect), _lanes(out, expect)


def test_the_exact_posed_path_is_within_the_seeded_tolerance_in_every_lane(case):
    """``exact=True``: the float64 host build of each pose, the engine's
    rotated camera, texel for texel even on the views aligned with the cube."""
    frames, _, bases, expect = case
    out = program.session(CFG, "cpu").render_posed(frames, bases, exact=True)
    assert _within(out, expect, SEEDED_TOL), _lanes(out, expect)


@pytest.mark.parametrize("exact", [False, True])
def test_bases_as_a_tensor_render_as_the_same_bases_from_numpy(case, monkeypatch, exact):
    """A ``[B, 3, 3]`` float32 tensor reaches the kernel as it was given, with
    no copy (on a card: no upload a call), and renders as its values given as
    NumPy do; the exact path takes them to the host."""
    from blinky_tpu_torch.kernels import static_ray

    frames, _, bases, _ = case
    given = torch.as_tensor(bases, dtype=torch.float32)
    seen = []
    orig = static_ray.prep_posed_inputs
    monkeypatch.setattr(static_ray, "prep_posed_inputs",
                        lambda f, b, *a: seen.append(b) or orig(f, b, *a))
    sess = program.session(CFG, "cpu")
    out = sess.render_posed(frames, given, exact=exact)
    assert torch.equal(out, sess.render_posed(frames, given.numpy(), exact=exact))
    if not exact:
        assert seen[0] is given and orig(frames, given, *_prep_args(sess))[1] is given


def _prep_args(sess):
    kernel = sess._posed_cache[1]
    return kernel.platesize, kernel.background, kernel.device


def test_the_control_reads_above_the_tolerances(case):
    """The reference one precision down reads above the seeded lanes'
    tolerance in every seeded lane, and above the identity's."""
    frames, _, bases, expect = case
    control = ref_posed.Posed(CFG, "cpu", hi=torch.float32, lo=torch.bfloat16)
    lanes = _lanes(control(frames, bases), expect)
    assert (lanes[2:] > 10 * SEEDED_TOL).all() and lanes[0] > IDENTITY_TOL, lanes


def _neighbours_pose(bases):
    out = bases.copy()
    out[3] = bases[4]
    return out


def _transposed(bases):
    return np.swapaxes(bases, -1, -2).copy()


@pytest.mark.parametrize("fault", [_neighbours_pose, _transposed])
def test_a_planted_fault_reads_above_the_tolerances(case, fault):
    frames, _, bases, expect = case
    out = program.session(CFG, "cpu").render_posed(frames, fault(bases))
    assert not _within(out, expect), _lanes(out, expect)
