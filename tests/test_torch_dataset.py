"""The port's demo containers, importers, prefetching batch iterator and
``timedemo`` (blinky_tpu_torch/io/dataset.py, io/cubemap.py's
``from_batch_layout``, utils/timing.py) against blinky_tpu's, with
tests/test_dataset.py as the model: the same seeded inputs give equal
arrays, and the same exception types (tolerance 0).  ``timedemo`` on
``Session(device="cpu")`` gives the JAX Session's screens bit for bit.
The CLI cases (``demo-import``) wait for the port's CLI (ROADMAP §1 item 8).
The threaded tests join with bounded timeouts and finish in seconds."""

import re
import threading
import time

import numpy as np
import pytest
import torch

from blinky_tpu.api import Session as JSession
from blinky_tpu.io import cubemap as jcubemap
from blinky_tpu.io import dataset as jdataset
from blinky_tpu.io.png import encode_png as jencode_png
from blinky_tpu.utils import timing as jtiming
from blinky_tpu_torch import globes
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io import cubemap, dataset
from blinky_tpu_torch.io.png import encode_png
from blinky_tpu_torch.io.ppm import encode_ppm
from blinky_tpu_torch.palette import default_palette
from blinky_tpu_torch.utils import timing


def _demo_frames(n=10, S=48):
    base = cubemap.synthetic_cubemap(S)
    return np.stack([np.roll(base, i, axis=2) for i in range(n)])


def _rgba_frames(n, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, 6, S, S), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("with_poses", [False, True])
@pytest.mark.parametrize("kind", ["u8", "u32"])
def test_demo_roundtrip_across_packages(tmp_path, kind, with_poses):
    frames = _demo_frames(4, 16) if kind == "u8" else _rgba_frames(4, 8)
    poses = np.random.default_rng(1).uniform(-90, 90, (4, 3)) if with_poses else None
    for writer, reader in ((dataset.write_demo, jdataset.read_demo),
                           (jdataset.write_demo, dataset.read_demo)):
        p = tmp_path / "demo.npz"
        writer(p, frames, default_palette(), poses)
        d = reader(p)
        assert d["frames"].dtype == frames.dtype
        np.testing.assert_array_equal(d["frames"], frames)
        np.testing.assert_array_equal(d["palette"], default_palette())
        if with_poses:
            np.testing.assert_array_equal(d["poses"], poses.astype(np.float32))
        else:
            assert d["poses"] is None


def test_write_demo_rejects_other_dtypes(tmp_path):
    for mod in (dataset, jdataset):
        with pytest.raises(ValueError, match="uint8 or uint32"):
            mod.write_demo(tmp_path / "x.npz", np.zeros((1, 6, 4, 4), np.int16),
                           default_palette())


POSE_TEXTS = ["0 0 0\n1, 2, 3\n// comment\n4 5 6\n-7 80 0\n", "", "// nothing\n\n",
              "1.5e2,-3,  4 // trailing\n", "1 2\n", "1 2 3 4\n", "x y z\n", "1,,2,3\n"]


@pytest.mark.parametrize("text", POSE_TEXTS, ids=repr)
def test_parse_pose_track_matches(text):
    outs = []
    for mod in (dataset, jdataset):
        try:
            outs.append(mod.parse_pose_track(text))
        except ValueError as e:
            outs.append(str(e))
    if isinstance(outs[0], str):
        assert outs[0] == outs[1]
    else:
        assert outs[0].dtype == np.float32 and outs[0].shape[-1:] in ((3,), (0,))
        np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("kind", ["u8", "u32"])
@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (1, 4), (5, 1), (3, 64)])
def test_batch_iterator_equals_jax(n, batch, kind):
    frames = _demo_frames(n, 8) if kind == "u8" else _rgba_frames(n, 8, seed=n)
    got = list(dataset.FrameBatchIterator(frames, batch=batch))
    want = list(jdataset.FrameBatchIterator(frames, batch=batch))
    assert len(got) == len(want) == len(dataset.FrameBatchIterator(frames, batch))
    assert [v for _, v in got] == [v for _, v in want]
    for (a, _), (b, _) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == (6, 8, 8, batch)
        np.testing.assert_array_equal(a, b)
    last, n_valid = got[-1]
    assert (last[..., n_valid:] == 0).all()  # zero padding
    np.testing.assert_array_equal(cubemap.from_batch_layout(last)[:n_valid],
                                  frames[(len(got) - 1) * batch:])


@pytest.mark.parametrize("bad", ["three_dims", "non_square"])
def test_iterator_propagates_worker_errors(bad):
    """A packing failure in the prefetch thread raises in the consumer.
    Three-dimensional frames fail alike (ValueError); non-square u8 plates
    fail the port's packer's check (ValueError), the JAX packer's assert."""
    frames = (np.zeros((5, 8, 8), np.uint8) if bad == "three_dims"
              else np.zeros((5, 6, 8, 9), np.uint8))
    with pytest.raises(ValueError):
        list(dataset.FrameBatchIterator(frames, batch=2))
    with pytest.raises((ValueError, AssertionError)) as jerr:
        list(jdataset.FrameBatchIterator(frames, batch=2))
    if bad == "three_dims":
        assert jerr.type is ValueError


def _wait_threads(before, timeout=5.0):
    deadline = time.monotonic() + timeout
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.02)
    return threading.active_count()


@pytest.mark.parametrize("prefetch", [1, 3])
def test_iterator_abandonment_does_not_hang(prefetch):
    """An abandoned iterator's worker gives up its bounded put and ends."""
    before = threading.active_count()
    frames = np.zeros((64, 6, 8, 8), np.uint8)
    it = iter(dataset.FrameBatchIterator(frames, batch=4, prefetch=prefetch))
    next(it)
    it.close()
    assert _wait_threads(before) <= before
    it = iter(dataset.FrameBatchIterator(frames, batch=4, prefetch=prefetch))
    next(it)
    del it  # the generator's finally runs when it is collected
    assert _wait_threads(before) <= before


def _saveglobe_dir(tmp_path, S, N):
    seq = np.stack([np.roll(cubemap.synthetic_cubemap(S), i, axis=2) for i in range(N)])
    for i in range(N):
        cubemap.save_globe_pcx(tmp_path / f"frame{i:04d}_", seq[i], globes.get("cube"),
                               default_palette(), with_margins=True)
    return seq


@pytest.mark.parametrize("S,N", [(16, 1), (32, 4)])
def test_import_saveglobe_dir_equals_jax(tmp_path, S, N):
    seq = _saveglobe_dir(tmp_path, S, N)
    frames, pal, stems = dataset.import_saveglobe_dir(tmp_path)
    jframes, jpal, jstems = jdataset.import_saveglobe_dir(tmp_path)
    np.testing.assert_array_equal(frames, seq)
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(pal, jpal)
    assert stems == jstems == [f"frame{i:04d}_" for i in range(N)]
    # masked (non-full) dumps import as-is, 0xFE margins included
    for i in range(N):
        cubemap.save_globe_pcx(tmp_path / f"m{i:04d}_", seq[i], globes.get("cube"),
                               default_palette())
    masked, _, _ = dataset.import_saveglobe_dir(tmp_path, numplates=6)
    np.testing.assert_array_equal(masked, jdataset.import_saveglobe_dir(tmp_path, 6)[0])
    assert (masked[N:] == 0xFE).any()


def _import_outcomes(call, directory):
    outs = []
    for mod in (dataset, jdataset):
        try:
            outs.append(("ok", call(mod, directory)))
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            outs.append(("raised", type(e), str(e)))
    assert outs[0][0] == outs[1][0], outs
    return outs


@pytest.mark.parametrize("case", ["empty", "missing_plate", "size_mismatch"])
def test_import_saveglobe_dir_errors_match(tmp_path, case):
    if case != "empty":
        _saveglobe_dir(tmp_path, 8, 2)
    if case == "missing_plate":
        (tmp_path / "frame0001_3.pcx").unlink()
    if case == "size_mismatch":
        cubemap.save_globe_pcx(tmp_path / "frame0001_", cubemap.synthetic_cubemap(16),
                               globes.get("cube"), default_palette(), with_margins=True)
    outs = _import_outcomes(lambda m, d: m.import_saveglobe_dir(d), tmp_path)
    assert outs[0] == outs[1] and outs[0][0] == "raised"


@pytest.mark.parametrize("fmt", ["png", "ppm", "gray_png"])
def test_import_rgb_faces_dir_equals_jax(tmp_path, fmt):
    rng = np.random.default_rng(len(fmt))
    S, N = 12, 3
    faces = rng.integers(0, 256, (N, 6, S, S, 3), np.uint8)
    for n in range(N):
        for i in range(6):
            if fmt == "ppm":
                data = encode_ppm(faces[n, i])
            else:
                data = encode_png(faces[n, i, ..., 0] if fmt == "gray_png" else faces[n, i])
            (tmp_path / f"f{n:02d}_{i}.{fmt[-3:]}").write_bytes(data)
    frames, stems = dataset.import_rgb_faces_dir(tmp_path)
    jframes, jstems = jdataset.import_rgb_faces_dir(tmp_path)
    assert frames.dtype == np.uint32 and frames.shape == (N, 6, S, S)
    np.testing.assert_array_equal(frames, jframes)
    assert stems == jstems
    want = faces[..., :1].repeat(3, -1) if fmt == "gray_png" else faces
    np.testing.assert_array_equal(frames & 0xFF, want[..., 0])
    (tmp_path / "f01_2.png").unlink(missing_ok=True)
    (tmp_path / "f01_2.ppm").unlink(missing_ok=True)
    outs = _import_outcomes(lambda m, d: m.import_rgb_faces_dir(d), tmp_path)
    assert outs[0] == outs[1] and outs[0][0] == "raised"


@pytest.mark.parametrize("platesize", [8, 16])
def test_import_equirect_dir_equals_jax(tmp_path, platesize):
    rng = np.random.default_rng(platesize)
    for n in range(2):
        (tmp_path / f"pano{n}.png").write_bytes(
            jencode_png(rng.integers(0, 256, (32, 64, 3), np.uint8)))
    (tmp_path / "pano2.ppm").write_bytes(encode_ppm(rng.integers(0, 256, (32, 64, 3),
                                                                 np.uint8)))
    frames, stems = dataset.import_equirect_dir(tmp_path, platesize=platesize)
    jframes, jstems = jdataset.import_equirect_dir(tmp_path, platesize=platesize)
    assert frames.shape == (3, 6, platesize, platesize) and frames.dtype == np.uint32
    np.testing.assert_array_equal(frames, jframes)
    assert stems == jstems == ["pano0", "pano1", "pano2"]
    (tmp_path / "pano3.png").write_bytes(encode_png(np.zeros((16, 64, 3), np.uint8)))
    outs = _import_outcomes(lambda m, d: m.import_equirect_dir(d, platesize=8), tmp_path)
    assert outs[0] == outs[1] and outs[0][0] == "raised"
    empty = tmp_path / "empty"
    empty.mkdir()
    outs = _import_outcomes(lambda m, d: m.import_equirect_dir(d), empty)
    assert outs[0] == outs[1] and outs[0][0] == "raised"


@pytest.mark.parametrize("kind", ["u8", "u32"])
@pytest.mark.parametrize("rubix,decode_rgb", [(None, False), (True, False), (None, True),
                                              (True, True)])
def test_timedemo_equals_jax(kind, rubix, decode_rgb):
    """The last (padded) batch's screens bit-equal the JAX Session's, the
    clock counts the valid frames only, and the console gets the line
    (packed-RGBA frames render as they are under decode_rgb, in both)."""
    frames = _demo_frames(10) if kind == "u8" else _rgba_frames(10, 48, seed=4)
    sess = Session(64, 48, device="cpu")
    jsess = JSession(64, 48, backend="numpy")
    out, clock = dataset.timedemo(sess, frames, batch=4, rubix=rubix, decode_rgb=decode_rgb)
    jout, jclock = jdataset.timedemo(jsess, frames, batch=4, rubix=rubix,
                                     decode_rgb=decode_rgb)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    got = out.numpy() if out.dtype != torch.uint32 else out.view(torch.int32).numpy()
    want = np.asarray(jout)
    np.testing.assert_array_equal(got.view(want.dtype), want)
    assert clock.frames == jclock.frames == 10
    line = sess.console[-1]
    assert re.fullmatch(r"10 frames +\d+\.\d seconds +\d+\.\d fps", line), line
    assert re.fullmatch(r"10 frames +\d+\.\d seconds +\d+\.\d fps", jsess.console[-1])


def test_timedemo_of_no_frames():
    sess = Session(64, 48, device="cpu")
    out, clock = dataset.timedemo(sess, np.zeros((0, 6, 48, 48), np.uint8), batch=4)
    assert out is None and clock.frames == 0
    assert sess.console[-1].startswith("0 frames")


@pytest.mark.parametrize("kind", ["u8", "u32"])
def test_from_batch_layout_equals_jax(kind):
    frames = _demo_frames(5, 8) if kind == "u8" else _rgba_frames(5, 8)
    packed = cubemap.to_batch_layout(frames)
    np.testing.assert_array_equal(packed, jcubemap.to_batch_layout(frames))
    back = cubemap.from_batch_layout(packed)
    np.testing.assert_array_equal(back, jcubemap.from_batch_layout(packed))
    np.testing.assert_array_equal(back, frames)
    assert back.flags.c_contiguous


def test_timings_and_frame_clock_report_alike():
    for mod in (timing, jtiming):
        t = mod.Timings()
        for _ in range(3):
            with t.stage("pack"):
                pass
        with t.stage("render"):
            time.sleep(0.002)
        assert t.counts == {"pack": 3, "render": 1}
        assert re.fullmatch(r"pack:\d+\.\d\dms  render:\d+\.\d\dms", t.report())
        clock = mod.FrameClock()
        clock.tick(7)
        clock.tick()
        assert clock.frames == 8 and clock.fps > 0
        assert re.fullmatch(r"8 frames +\d+\.\d seconds +\d+\.\d fps", clock.report())


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with timing.profile_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    assert path.stat().st_size > 0 and path.read_text().lstrip().startswith("{")
