"""The port's ``.dem`` reader and writer (blinky_tpu_torch/io/demfile.py)
against blinky_tpu's, with tests/test_demfile.py as the model: the same
poses and messages give the same bytes, every header quirk of
``CL_PlayDemo_f`` parses alike, and ``lerp_pose_track`` (the engine's
shortest-arc playback lerp) is bit-equal in float32 (tolerance 0).  The CLI
case (``demo-import --dem``) waits for the port's CLI (ROADMAP §1 item 8)."""

import struct

import numpy as np
import pytest

from blinky_tpu.io import demfile as jdem
from blinky_tpu_torch.io import demfile as dem


def _poses(n, seed=7):
    return np.random.default_rng(seed).uniform(-180, 360, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("cdtrack", [-1, 4, 123456])
@pytest.mark.parametrize("n", [0, 1, 12])
def test_roundtrip_bytes_equal(tmp_path, n, cdtrack):
    poses = _poses(n, seed=n)
    msgs = [bytes([i]) * (i * 3 + 1) for i in range(n)]
    a, b = tmp_path / "p.dem", tmp_path / "j.dem"
    dem.write_dem(a, poses, messages=msgs, cdtrack=cdtrack)
    jdem.write_dem(b, poses, messages=msgs, cdtrack=cdtrack)
    assert a.read_bytes() == b.read_bytes()
    got, want = dem.read_dem(a, keep_messages=True), jdem.read_dem(a, keep_messages=True)
    assert got.cdtrack == want.cdtrack == cdtrack
    np.testing.assert_array_equal(got.poses, poses)
    np.testing.assert_array_equal(got.message_sizes, want.message_sizes)
    assert got.messages == want.messages == msgs
    assert len(got) == n
    assert dem.read_dem(a.read_bytes()).messages is None


def test_default_message_is_svc_nop(tmp_path):
    p = tmp_path / "n.dem"
    dem.write_dem(p, _poses(3))
    d = dem.read_dem(p, keep_messages=True)
    assert all(m == b"\x01" for m in d.messages) and d.cdtrack == -1


BODY = struct.pack("<i3f", 1, 0.0, 0.0, 0.0) + b"\x01"
HEADERS = [bytes((c | 128) for c in b"-1") + b"\n", b" " * 10 + b"2\n", b" " * 12 + b"2\n",
           b"zap\n", b"2xyz\n", b" \t-7 foo\n", b"\x8a3\n", b"+5\n", b"\n", b"99999999999\n"]


@pytest.mark.parametrize("header", HEADERS, ids=repr)
def test_header_parse_matches_engine(header):
    outs = []
    for mod in (dem, jdem):
        try:
            outs.append(mod.read_dem(header + BODY).cdtrack)
        except ValueError as e:
            outs.append(str(e))
    assert outs[0] == outs[1]


def test_oversize_and_truncated_blocks():
    good = struct.pack("<i3f", 1, 1.0, 2.0, 3.0) + b"\x01"
    for mod in (dem, jdem):
        with pytest.raises(ValueError, match="MAX_MSGLEN"):
            mod.read_dem(b"-1\n" + struct.pack("<i3f", mod.MAX_MSGLEN + 1, 0, 0, 0))
        d = mod.read_dem(b"-1\n" + good + struct.pack("<i3f", 100, 9.0, 9.0, 9.0) + b"xy")
        assert len(d) == 1
        np.testing.assert_array_equal(d.poses[0], [1, 2, 3])
        with pytest.raises(ValueError, match="MAX_MSGLEN"):
            mod.write_dem("/dev/null", _poses(1), messages=[b"\0" * (mod.MAX_MSGLEN + 1)])
        with pytest.raises(ValueError, match="messages"):
            mod.write_dem("/dev/null", np.zeros((2, 3)), messages=[b"a"])


@pytest.mark.parametrize("n_out", [1, 2, 5, 96, 1000])
@pytest.mark.parametrize("n_in", [1, 2, 3, 24])
def test_lerp_pose_track_bit_equal(n_in, n_out):
    track = _poses(n_in, seed=n_in * 100 + n_out)
    got = dem.lerp_pose_track(track, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out, 3)
    np.testing.assert_array_equal(got.view(np.int32),
                                  jdem.lerp_pose_track(track, n_out).view(np.int32))


def test_lerp_pose_track_shortest_arc():
    out = dem.lerp_pose_track(np.array([[0, 350, 0], [0, 10, 0]], np.float32), 3)
    np.testing.assert_allclose(out[1], [0, 360, 0], atol=1e-4)
    out = dem.lerp_pose_track(np.array([[0, 0, 0], [0, 180, 0]], np.float32), 3)
    np.testing.assert_allclose(out[1], [0, -90, 0], atol=1e-4)  # d = +180 wraps to -180
    for mod in (dem, jdem):
        with pytest.raises(ValueError, match="empty"):
            mod.lerp_pose_track(np.zeros((0, 3), np.float32), 4)
