"""Time-sliced exact builds in the port (blinky_tpu_torch.lensmap.progressive
and Session(build_budget_s=...)), with tests/test_progressive.py as the
model: row blocks bit-equal a one-shot build, the partial table shows only
built rows, a Session's sliced build swaps to the exact table bit for bit
(as blinky_tpu's does), and the preview is the float32 device build once
that builder is warm on the session's device.  Tolerance 0 throughout: the
tables and screens are integers, and every comparison is between exact
float64 host builds or between two renders of one table."""

import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.api import Session as JSession
from blinky_tpu.lensmap.progressive import ProgressiveHostBuild as JProgressive
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.camera import view_basis_from_angles
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.lensmap.builder import inverse_grid
from blinky_tpu_torch.lensmap.progressive import ProgressiveHostBuild

FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")


def _frames(size=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (6, size, size), dtype=np.uint8)


def _equal_tables(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


def _lens(name, globe="cube", zoom=("fov", 180), W=96, H=72):
    g = globes.get(globe)
    lens = lenses.get(name, g)
    return g, lens, calc_scale(Zoom(*zoom), lens, W, H)


@pytest.mark.parametrize("view", [None, (10.0, 30.0, 5.0)], ids=["identity", "rotated"])
@pytest.mark.parametrize("name,globe", [("panini", "cube"), ("mollweide", "cube"),
                                        ("winkeltripel", "tetra"), ("stereographic", "fast")])
def test_chunked_build_bitexact_vs_oneshot(name, globe, view):
    """Row blocks are bit-identical to the same rows of a one-shot build,
    the repeat-until solvers (mollweide) and a view basis included, and the
    finished table equals blinky_tpu's progressive build."""
    g, lens, scale = _lens(name, globe)
    vb = None if view is None else view_basis_from_angles(*view)
    pb = ProgressiveHostBuild(lens, g, scale, 96, 72, 48, view_basis=vb)
    steps = 0
    while not pb.step(0.002):  # a tiny budget: many blocks
        steps += 1
        assert 0.0 <= pb.progress < 1.0
    assert steps >= 1
    lm = pb.result()
    _equal_tables(lm, build_lensmap(lens, g, scale, 96, 72, 48, view_basis=vb))
    jg = jglobes.get(globe)
    jpb = JProgressive(jlenses.get(name, jg), jg, scale, 96, 72, 48, view_basis=vb)
    _equal_tables(lm, jpb.run())


@pytest.mark.parametrize("rows", [(0, 1), (5, 23), (40, 72), (71, 72)])
def test_row_range_is_the_same_rows(rows):
    """inverse_grid(row_range=(r0, r1)) gives rows r0..r1 of the one-shot
    grid, with plates_used covering only the block."""
    g, lens, scale = _lens("hammer", zoom=("contain",))
    r0, r1 = rows
    full = inverse_grid(lens, g, np.float64(scale), 96, 72, 48, 10, 4.0, 1.0)
    part = inverse_grid(lens, g, np.float64(scale), 96, 72, 48, 10, 4.0, 1.0,
                        row_range=rows)
    for f in FIELDS[:-1]:
        np.testing.assert_array_equal(part[f], full[f][r0:r1], err_msg=f)
    used = [(full["plate"][r0:r1][full["valid"][r0:r1]] == k).any() for k in range(6)]
    np.testing.assert_array_equal(part["plates_used"], used)


def test_partial_shows_built_rows_only():
    """step(0) builds one INITIAL_ROWS block; partial() shows those rows,
    snapshots them (later steps leave it alone) and equals blinky_tpu's
    partial after the same step."""
    g, lens, scale = _lens("panini", W=64, H=48)
    pb = ProgressiveHostBuild(lens, g, scale, 64, 48, 32)
    pb.step(0.0)
    assert pb.progress == ProgressiveHostBuild.INITIAL_ROWS / 48
    part = pb.partial()
    built = part.valid.any(axis=1)
    assert built[:1].all() and not built[ProgressiveHostBuild.INITIAL_ROWS:].any()
    jg = jglobes.get("cube")
    jpb = JProgressive(jlenses.get("panini", jg), jg, scale, 64, 48, 32)
    jpb.step(0.0)
    _equal_tables(part, jpb.partial())
    before = part.valid.copy()
    pb.run()
    np.testing.assert_array_equal(part.valid, before)
    assert pb.result().valid.any(axis=1).all()


def test_result_before_done_raises():
    g, lens, scale = _lens("panini", W=64, H=48)
    pb = ProgressiveHostBuild(lens, g, scale, 64, 48, 32)
    assert not pb.done and pb.progress == 0.0
    with pytest.raises(ValueError, match="not finished"):
        pb.result()
    with pytest.raises(ValueError, match="inverse"):
        ProgressiveHostBuild(lenses.get("sinusoidal", g), g, 1.0, 64, 48, 32)


@pytest.mark.parametrize("lens", ["winkeltripel", "mollweide", "stereographic"])
def test_session_time_sliced_build_swaps_to_exact(lens):
    """With build_budget_s set, render() returns at once with a preview,
    reports progress, and converges to the blocking exact result; blinky_tpu's
    sliced Session ends on the same screen."""
    frames = _frames()
    # a first slice shorter than any block: the first render builds only
    # INITIAL_ROWS of the 48 rows, however fast the host (a 1 ms slice can
    # finish a 64x48 build at once)
    sess = Session(64, 48, platesize=32, build_budget_s=1e-9, device="cpu")
    sess.cmd(f"f_lens {lens}")
    assert sess.render(frames).shape == (48, 64)
    assert sess.build_progress is not None
    sess.build_budget_s = 0.001
    for _ in range(500):
        out = sess.render(frames)
        if sess.build_progress is None:
            break
    assert sess.build_progress is None
    blocking = Session(64, 48, platesize=32, backend="numpy", device="cpu")
    blocking.cmd(f"f_lens {lens}")
    np.testing.assert_array_equal(out.numpy(), blocking.render(frames).numpy())
    _equal_tables(sess.lensmap, blocking.lensmap)
    jsess = JSession(64, 48, platesize=32, build_budget_s=0.001)
    jsess.cmd(f"f_lens {lens}")
    jsess.lensmap  # finishes its build
    np.testing.assert_array_equal(out.numpy(), np.asarray(jsess.render(frames)))


def test_preview_prefers_partial_until_device_warm():
    """A cold device builder means the growing partial table is the preview
    (pixels appear, the unbuilt rows show the background); once
    warm_device_builder has run on the session's device (the CPU here) the
    same lens previews through the float32 builder, whose tables are
    tensors."""
    frames = _frames(seed=1)
    bg = np.full((48, 64), 251, np.uint8)
    sess = Session(64, 48, platesize=32, build_budget_s=0.0005, device="cpu")
    sess.set_background(bg)
    sess.cmd("f_lens winkeltripel")
    out = sess.render(frames).numpy()
    assert sess._preview_is_partial and sess.build_progress is not None
    rows = sess._lensmap.valid.any(axis=1)
    assert not rows.all()
    np.testing.assert_array_equal(out[~rows], 251)  # unbuilt rows: the background
    for _ in range(200):
        sess.render(frames)
        if sess.build_progress is None or sess._lensmap.valid.any(axis=1).sum() > rows.sum():
            break
    assert sess.build_progress is None or sess._lensmap.valid.any(axis=1).sum() > rows.sum()
    assert sess.warm_device_builder()
    sess.cmd("f_fov 140")  # the same LensDef, a new build
    sess.render(frames)
    assert not sess._preview_is_partial
    assert isinstance(sess._lensmap.flat_idx, torch.Tensor)
    assert sess.build_progress is not None
    assert isinstance(sess.lensmap.flat_idx, np.ndarray)  # the exact table now
    assert sess.build_progress is None and sess._lensmap_np is None


def test_partial_preview_renders_the_partial_table():
    """Each render through the partial preview equals host_remap of the
    partial table it shows: built rows the lens, the rest the background."""
    from blinky_tpu_torch.kernels.remap import host_remap

    frames = _frames(seed=2)
    bg = np.random.default_rng(3).integers(0, 256, (48, 64), dtype=np.uint8)
    sess = Session(64, 48, platesize=32, build_budget_s=0.0005, device="cpu")
    sess.set_background(bg)
    sess.cmd("f_lens mollweide")
    n = 0
    while True:
        out = sess.render(frames).numpy()
        lm = sess._lensmap
        np.testing.assert_array_equal(out, host_remap(lm, frames, sess.palette, bg))
        n += 1
        if sess.build_progress is None:
            break
    assert n >= 2


def test_session_lensmap_property_finishes_pending_build():
    """Session.lensmap is the exact table: it finishes the pending build."""
    sess = Session(64, 48, platesize=32, build_budget_s=0.0005, device="cpu")
    sess.cmd("f_lens mollweide")
    sess.render(_frames())
    assert sess.build_progress is not None
    lm = sess.lensmap
    assert sess.build_progress is None
    ref = Session(64, 48, platesize=32, backend="numpy", device="cpu")
    ref.cmd("f_lens mollweide")
    _equal_tables(lm, ref.lensmap)


def test_session_change_mid_build_restarts():
    """A lens change while a sliced build is pending discards it and starts
    the new one."""
    frames = _frames(seed=4)
    sess = Session(64, 48, platesize=32, build_budget_s=0.0005, device="cpu")
    sess.cmd("f_lens winkeltripel")
    sess.render(frames)
    assert sess.build_progress is not None
    sess.cmd("f_lens hammer")
    for _ in range(500):
        sess.render(frames)
        if sess.build_progress is None:
            break
    ref = Session(64, 48, platesize=32, backend="numpy", device="cpu")
    ref.cmd("f_lens hammer")
    np.testing.assert_array_equal(sess.render(frames).numpy(), ref.render(frames).numpy())


def test_forward_lens_and_host_render_under_a_budget():
    """A forward lens builds in one pass (no pending build); render_host
    takes the same sliced state machine on the host."""
    frames = _frames(seed=5)
    sess = Session(64, 48, platesize=32, build_budget_s=0.0005, device="cpu")
    sess.cmd("f_lens sinusoidal")
    sess.render(frames)
    assert sess.build_progress is None
    sess.cmd("f_lens winkeltripel")
    outs = []
    for _ in range(500):
        outs.append(sess.render_host(frames))
        if sess.build_progress is None:
            break
    ref = Session(64, 48, platesize=32, backend="numpy", device="cpu")
    ref.cmd("f_lens winkeltripel")
    np.testing.assert_array_equal(outs[-1], ref.render_host(frames))


@pytest.mark.parametrize("mode", ["compact", "fused"])
def test_render_equirect_steps_aside_while_pending(mode):
    """While a sliced build is pending, compact and fused render the faces
    through the preview (each call advancing one slice) and compose no
    chain; once the exact table lands they return to their mode, equal to
    a blocking Session's."""
    rng = np.random.default_rng(6)
    panos = rng.integers(0, 2**32, (32, 64, 2), dtype=np.uint64).astype(np.uint32)
    sess = Session(48, 36, platesize=24, build_budget_s=0.0005, device="cpu")
    sess.cmd("f_lens winkeltripel")
    sess.render_equirect(panos, mode=mode)
    assert sess.build_progress is not None and not sess._equirect_fused
    for _ in range(500):
        out = sess.render_equirect(panos, mode=mode)
        if sess.build_progress is None:
            break
    assert sess.build_progress is None
    final = sess.render_equirect(panos, mode=mode)
    assert sess._equirect_fused
    ref = Session(48, 36, platesize=24, device="cpu")
    ref.cmd("f_lens winkeltripel")
    want = ref.render_equirect(panos, mode=mode).view(torch.int32)
    assert torch.equal(final.view(torch.int32), want)
    assert torch.equal(out.view(torch.int32), want)


def test_reusable_static_lensmap_refuses_a_preview():
    """A posed ray table is never seeded from a preview: not while a build
    is pending, and not from a partial table."""
    sess = Session(64, 48, platesize=32, build_budget_s=0.0005, device="cpu")
    sess.cmd("f_lens mollweide")
    sess.render(_frames())
    scale = sess._lensmap.scale
    assert sess.build_progress is not None
    assert sess._reusable_static_lensmap(scale, 32, 1) is None
    sess._advance_build(None)
    assert sess._reusable_static_lensmap(scale, 32, 1) is sess._lensmap
    sess._preview_is_partial = True
    assert sess._reusable_static_lensmap(scale, 32, 1) is None
