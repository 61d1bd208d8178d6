"""The port's browser viewer (blinky_tpu_torch.viewer) against blinky_tpu's,
with tests/test_viewer.py as the model: its endpoints driven over real HTTP
on ``Session(device="cpu")``.

Where both viewers render through the exact float64 host lensmap (static
views, ``fisheye 0`` is not used here, captures), the port must serve the
JAX viewer's bytes for the same requests: ``/frame.png``, ``/record.gif``
and the console JSON.  A frame on the static-ray posed preview (a forward
lens under a view rotation) is held bit-equal to the port's own
``Session.render_posed``, as the JAX test holds its own; the two
packages' posed previews agree within the port's posed rule, 0.005 of the
pixels (tests/test_torch_posed.py's ``CPU_FUZZ``: the JAX side is jitted).
``/state`` carries two keys the JAX viewer's lacks, ``device_ready`` and
``device_error``.
"""

import json
import threading
import time
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest

from blinky_tpu.api import Session as JSession
from blinky_tpu.viewer import Viewer as JViewer
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.io.gif import decode_gif
from blinky_tpu_torch.io.png import decode_png
from blinky_tpu_torch.viewer import Viewer

POSED_FUZZ = 0.005


def _np(t):
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _get(v, path):
    if path.startswith(("/cmd", "/key", "/record.gif")) or "follow=1" in path:
        sep = "&" if "?" in path else "?"
        path += f"{sep}t={v.token}"
    with urlopen(v.address + path, timeout=60) as r:
        return r.status, dict(r.headers), r.read()


def _status(v, path):
    try:
        with urlopen(v.address + path, timeout=60) as r:
            return r.status
    except HTTPError as e:
        return e.code


class Pair:
    """The JAX viewer and the port's on the same session arguments and
    frames; :meth:`get` sends one request to both."""

    def __init__(self, W, H, S, frames, poses=None, cmds=(), **kw):
        self.jsess = JSession(W, H, platesize=S, **kw)
        self.sess = Session(W, H, platesize=S, device="cpu", **kw)
        for c in cmds:
            self.jsess.cmd(c)
            self.sess.cmd(c)
        self.jv = JViewer(self.jsess, frames, poses=poses)
        self.v = Viewer(self.sess, frames, poses=poses)
        self.jv.start()
        self.v.start()

    def get(self, path):
        return _get(self.jv, path), _get(self.v, path)

    def stop(self):
        self.jv.stop()
        self.v.stop()


@pytest.fixture
def pair():
    frames = np.stack([np.roll(synthetic_cubemap(32), i, axis=2) for i in range(3)])
    p = Pair(64, 48, 32, frames, cmds=("f_shortcutkeys",))
    yield p
    p.stop()


def test_page_and_state(pair):
    (jc, _, jpage), (c, _, page) = pair.get("/")
    assert jc == c == 200 and b"blinky-tpu" in page
    assert jpage.replace(pair.jv.token.encode(), b"T") == page.replace(pair.v.token.encode(), b"T")
    (_, _, jst), (_, _, st) = pair.get("/state")
    js, ps = json.loads(jst), json.loads(st)
    assert ps.pop("device_ready") is True and ps.pop("device_error") == ""
    assert js == ps and ps["frames"] == 3 and ps["lens"] == "panini"
    assert _status(pair.v, "/nope") == 404


def test_frame_render_and_commands(pair):
    (_, jh, jb), (_, h, b) = pair.get("/frame.png?i=1")
    assert b == jb and h["X-Status"] == jh["X-Status"]
    assert decode_png(b).shape == (48, 64, 3)
    (_, _, jc), (_, _, c) = pair.get("/cmd?c=f_lens%20hammer%3B%20f_rubix")
    assert json.loads(c) == json.loads(jc)
    assert pair.sess.lens_name == "hammer" and pair.sess.rubix_enabled
    (_, jh, jb2), (_, h, b2) = pair.get("/frame.png?i=1")
    assert b2 == jb2 and "f_lens hammer" in h["X-Status"] and b2 != b
    # drag-to-look on an inverse lens: the float32 device builder on both
    # sides (torch's against XLA:CPU's), so held to each other by the
    # float32 rule, and to the port's own render bit for bit
    pair.get("/cmd?c=setviewangles%2010%2045%200")
    (_, _, jb3), (c3, _, b3) = pair.get("/frame.png?i=0")
    assert c3 == 200 and b3 != b2
    np.testing.assert_array_equal(decode_png(b3),
                                  pair.sess.palette[_np(pair.sess.render(pair.v.frames[0]))])
    assert (decode_png(b3) != decode_png(jb3)).any(axis=-1).mean() <= 0.15
    (_, jh4, _), (_, h4, _) = pair.get("/frame.png?i=4")
    assert "frame 1/3" in h4["X-Status"] and h4["X-Status"] == jh4["X-Status"]


def test_shortcut_keys_over_http(pair):
    (_, _, jb), (_, _, b) = pair.get("/key?k=3")
    assert pair.sess.lens_name == pair.jsess.lens_name != "panini"
    assert json.loads(b) == json.loads(jb)
    (_, _, jb), (_, _, b) = pair.get("/key?k=z")
    assert json.loads(b)["console"] == [] == json.loads(jb)["console"]
    (_, _, jf), (_, _, f) = pair.get("/frame.png?i=0")
    assert f == jf


def test_render_error_surfaces_as_500(pair):
    def boom(i):
        raise RuntimeError("injected")

    pair.v.render_png = boom
    assert _status(pair.v, "/frame.png?i=0") == 500
    assert _status(pair.v, "/frame.png?i=zap") == 500


def test_viewer_input_validation():
    sess = Session(32, 24, platesize=16, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        Viewer(sess, np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="at least one frame"):
        Viewer(sess, np.zeros((0, 6, 16, 16), np.uint8))
    v = Viewer(sess, synthetic_cubemap(16))
    assert v.frames.shape[0] == 1


def test_state_changing_endpoints_require_token(pair):
    v, sess = pair.v, pair.sess
    assert _status(v, "/cmd?c=f_lens%20hammer") == 403
    assert _status(v, "/key?k=3&t=wrong") == 403
    assert _status(v, "/frame.png?i=0&follow=1") == 403
    assert _status(v, "/frame.png?i=0") == 200
    assert sess.lens_name == "panini"
    _, _, page = _get(v, "/")
    assert v.token.encode() in page
    assert _status(v, "/state") == 200


def test_follow_pose_track():
    frames = np.stack([synthetic_cubemap(32)] * 3)
    poses = np.array([[0, 0, 0], [0, 90, 0], [10, 180, 0]], np.float32)
    p = Pair(64, 48, 32, frames, poses=poses)
    try:
        (_, _, jst), (_, _, st) = p.get("/state")
        assert json.loads(st)["has_poses"] is True is json.loads(jst)["has_poses"]
        outs = []
        for i in range(3):
            (_, _, jb), (_, _, b) = p.get(f"/frame.png?i={i}&follow=1")
            # the posed frames are rotated views on the float32 builder
            np.testing.assert_array_equal(
                decode_png(b), p.sess.palette[_np(p.sess.render(frames[i]))])
            assert (decode_png(b) != decode_png(jb)).any(axis=-1).mean() <= 0.15
            outs.append(b)
        assert outs[0] != outs[1] != outs[2]
    finally:
        p.stop()
    v2 = Viewer(p.sess, frames, poses=np.zeros((0, 3), np.float32))
    assert v2.poses is None


def test_record_gif(pair):
    (_, jh, jb), (code, h, b) = pair.get("/record.gif?d=7")
    assert code == 200 and h["Content-Type"] == "image/gif"
    assert b == jb
    frames, pal, delays = decode_gif(b)
    assert frames.shape == (48, 64, 3) and delays == [7, 7, 7]
    np.testing.assert_array_equal(frames[..., 0], _np(pair.sess.render(pair.v.frames[0])))
    (_, _, jtwo), (_, _, two) = pair.get("/record.gif?from=1&n=2")
    assert two == jtwo and decode_gif(two)[0].shape[-1] == 2


def test_record_gif_fast_captures_posed_path(monkeypatch):
    import blinky_tpu_torch.lensmap.forward_raster as fr

    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)])
    v = Viewer(sess, frames)
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20eckert1%3B%20setviewangles%200%2030%200")
        _get(v, "/frame.png?i=0")
        calls = []
        orig = fr.build_forward
        monkeypatch.setattr(fr, "build_forward",
                            lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
        _, h, gif = _get(v, "/record.gif?n=1&fast=1")
        assert h["Content-Type"] == "image/gif" and not calls
        got = decode_gif(gif)[0]
        ref = _np(sess.render_posed(frames[0][..., None], np.asarray([[0.0, 30.0, 0.0]])))[0]
        np.testing.assert_array_equal(got[..., 0], ref)
    finally:
        v.stop()


def test_record_gif_fast_cold_key_compiles_inline():
    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)])
    v = Viewer(sess, frames)
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20eckert1%3B%20setviewangles%200%2030%200")
        _get(v, "/frame.png?i=0")
        stale = v._last_posed.copy()
        _get(v, "/cmd?c=f_rubix%201")
        _, h, gif = _get(v, "/record.gif?n=2&fast=1")
        got = decode_gif(gif)[0]
        assert (got[..., 0] != stale).any()
        ref = _np(sess.render_posed(v._posed_source(0), np.asarray([[0.0, 30.0, 0.0]])))[0]
        np.testing.assert_array_equal(got[..., 0], ref)
    finally:
        v.stop()


def test_record_gif_true_color_quantizes():
    from blinky_tpu_torch.kernels.remap import frames_to_rgba, unpack_rgb
    from blinky_tpu_torch.palette import default_palette

    u8 = np.stack([synthetic_cubemap(16)] * 2)
    rgba = np.stack([frames_to_rgba(f, default_palette()) for f in u8])
    p = Pair(48, 36, 16, rgba)
    try:
        (_, _, jb), (_, h, b) = p.get("/record.gif?n=2")
        assert h["Content-Type"] == "image/gif" and b == jb
        frames, pal, _ = decode_gif(b)
        assert frames.shape == (36, 48, 2)
        truth = unpack_rgb(_np(p.sess.render(rgba[0])).view(np.uint32))
        assert np.abs(pal[frames[..., 0]].astype(int) - truth.astype(int)).mean() < 8
        (_, _, jf), (_, _, f) = p.get("/frame.png?i=1")
        assert f == jf
    finally:
        p.stop()


def test_viewer_lens_switch_time_sliced():
    sess = Session(96, 72, platesize=48, device="cpu")
    assert sess.build_budget_s is None
    frames = synthetic_cubemap(48)[None]
    v = Viewer(sess, frames)
    assert sess.build_budget_s == pytest.approx(1 / 60)
    sess.build_budget_s = 2e-4
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20winkeltripel")
        _, headers, _ = _get(v, "/frame.png?i=0")
        assert sess.build_progress is not None and "[exact build" in headers["X-Status"]
        for _ in range(400):
            _, headers, body = _get(v, "/frame.png?i=0")
            if sess.build_progress is None:
                break
        assert sess.build_progress is None and "[exact build" not in headers["X-Status"]
    finally:
        v.stop()
    ref = JSession(96, 72, platesize=48, backend="numpy")
    ref.cmd("f_lens winkeltripel")
    np.testing.assert_array_equal(_np(sess.render(frames[0])), np.asarray(ref.render(frames[0])))
    np.testing.assert_array_equal(decode_png(body), sess.palette[np.asarray(ref.render(frames[0]))])


def test_record_gif_is_exact_during_pending_build():
    sess = Session(96, 72, platesize=48, build_budget_s=1e-6, device="cpu")
    frames = np.stack([synthetic_cubemap(48)] * 2)
    poses = np.array([[0, 0, 0], [0, 40, 0]], np.float32)
    v = Viewer(sess, frames, poses=poses)
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20winkeltripel")
        _get(v, "/frame.png?i=0")
        assert sess.build_progress is not None
        _, _, body = _get(v, "/record.gif?n=2&follow=1")
        got = decode_gif(body)[0]
    finally:
        v.stop()
    assert sess.build_budget_s == 1e-6
    ref = Session(96, 72, platesize=48, device="cpu")
    ref.cmd("f_lens winkeltripel")
    for k, (p, y, r) in enumerate(poses):
        ref.cmd(f"setviewangles {float(p)} {float(y)} {float(r)}")
        np.testing.assert_array_equal(got[..., k], _np(ref.render(frames[k])),
                                      err_msg=f"frame {k} not exact")


def test_drag_look_forward_lens_static_ray(monkeypatch):
    import blinky_tpu_torch.lensmap.forward_raster as fr

    calls = []
    orig = fr.build_forward
    monkeypatch.setattr(fr, "build_forward", lambda *a, **kw: (calls.append(a), orig(*a, **kw))[1])
    frames = np.stack([synthetic_cubemap(32)])
    p = Pair(64, 48, 32, frames)
    try:
        p.get("/cmd?c=f_lens%20eckert1")
        (_, _, jb0), (_, h0, b0) = p.get("/frame.png?i=0")
        assert "[static-ray pose]" not in h0["X-Status"] and b0 == jb0
        after_static = len(calls)
        p.get("/cmd?c=setviewangles%2010%2045%200")
        (_, _, jb1), (_, _, b1) = p.get("/frame.png?i=0")
        assert len(calls) == after_static
        p.get("/cmd?c=setviewangles%20-5%2090%200")
        (_, jh2, jb2), (_, h2, b2) = p.get("/frame.png?i=0")
        assert len(calls) == after_static
        assert "[static-ray pose]" in h2["X-Status"] and h2["X-Status"] == jh2["X-Status"]
        assert b1 != b2
        ref = _np(p.sess.render_posed(frames[0][..., None], np.asarray([[-5.0, 90.0, 0.0]])))[0]
        np.testing.assert_array_equal(decode_png(b2), p.sess.palette[ref])
        assert (decode_png(b2) != decode_png(jb2)).any(axis=-1).mean() <= POSED_FUZZ
        before_gif = len(calls)
        (_, _, jgif), (_, _, gif) = p.get("/record.gif?n=1")
        assert len(calls) > before_gif
        assert gif == jgif  # the exact per-pose capture: the host raster
        np.testing.assert_array_equal(decode_gif(gif)[0][..., 0],
                                      _np(p.sess.render(frames[0])))
    finally:
        p.stop()


def test_drag_look_forward_lens_rubix_expands():
    from blinky_tpu_torch.kernels.remap import expand_frames_tinted

    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)])
    v = Viewer(sess, frames)
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20eckert1%3B%20f_rubix%3B%20setviewangles%200%2030%200")
        _, _, b1 = _get(v, "/frame.png?i=0")
        (key1, src1), = v._posed_src.items()
        assert src1.shape[0] == 12
        _, _, b1b = _get(v, "/frame.png?i=0")
        assert v._posed_src[key1] is src1 and b1 == b1b
        ref = _np(sess.render_posed(expand_frames_tinted(frames[0][..., None], sess.palette),
                                    np.asarray([[0.0, 30.0, 0.0]])))[0]
        np.testing.assert_array_equal(decode_png(b1), sess.palette[ref])
        _get(v, "/cmd?c=f_rubix")
        deadline = time.time() + 60
        while time.time() < deadline:
            _, h2, b2 = _get(v, "/frame.png?i=0")
            if "[compiling posed pipeline]" not in h2["X-Status"]:
                break
            time.sleep(0.05)
        assert "[compiling posed pipeline]" not in h2["X-Status"]
        raw = [s for (i, rub, _), s in v._posed_src.items() if (i, rub) == (0, False)]
        assert raw and raw[0].shape[0] == 6 and b2 != b1
    finally:
        v.stop()


def test_drag_look_pose_scale_auto_smoke():
    sess = Session(64, 48, platesize=32, device="cpu")
    v = Viewer(sess, np.stack([synthetic_cubemap(32)]), pose_scale="auto")
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20eckert1%3B%20setviewangles%200%2030%200")
        code, h1, b1 = _get(v, "/frame.png?i=0")
        assert code == 200 and "[static-ray pose]" in h1["X-Status"]
        assert "[compiling posed pipeline]" not in h1["X-Status"]
        _get(v, "/cmd?c=setviewangles%200%2090%200")
        code, _, b2 = _get(v, "/frame.png?i=0")
        assert code == 200 and b2 != b1
    finally:
        v.stop()


def _eckert1_viewer():
    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)])
    sess.cmd("f_lens eckert1; setviewangles 0 30 0")
    return sess, frames, Viewer(sess, frames)


def test_blocking_capture_joins_inflight_posed_warm(monkeypatch):
    import blinky_tpu_torch.viewer as viewer_mod

    sess, frames, v = _eckert1_viewer()
    out1 = v._render_posed_frame(0)
    real = viewer_mod.Viewer._compile_posed_pipeline
    started, gate = threading.Event(), threading.Event()
    calls = []

    def slow(self, *a, **kw):
        calls.append(a)
        started.set()
        assert gate.wait(30)
        return real(self, *a, **kw)

    monkeypatch.setattr(viewer_mod.Viewer, "_compile_posed_pipeline", slow)
    sess.cmd("f_globe trism")
    out2 = v._render_posed_frame(0)
    np.testing.assert_array_equal(out2, out1)
    assert v._posed_stale and started.wait(10)
    t = v._posed_warming[v._posed_pipeline_key(v._posed_source(0))]
    assert t.is_alive()
    real_rp = type(sess).render_posed

    def render_asserting_join(self, *a, **kw):
        assert not t.is_alive(), "inline render overlapped the warm"
        return real_rp(self, *a, **kw)

    monkeypatch.setattr(type(sess), "render_posed", render_asserting_join)
    threading.Timer(0.2, gate.set).start()
    out3 = v._render_posed_frame(0, block=True)
    assert len(calls) == 1 and not v._posed_stale
    ref = _np(real_rp(sess, frames[0][..., None], np.asarray([[0.0, 30.0, 0.0]])))[0]
    np.testing.assert_array_equal(out3, ref)


def test_posed_preview_warmth_gate_serves_stale_frame(monkeypatch):
    import blinky_tpu_torch.viewer as viewer_mod

    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)])
    v = Viewer(sess, frames)
    v.start()
    try:
        _get(v, "/cmd?c=f_lens%20eckert1%3B%20setviewangles%200%2030%200")
        _, h1, b1 = _get(v, "/frame.png?i=0")
        assert "[static-ray pose]" in h1["X-Status"]
        real = viewer_mod.Viewer._compile_posed_pipeline

        def slow(self, *a, **kw):
            time.sleep(0.5)
            return real(self, *a, **kw)

        monkeypatch.setattr(viewer_mod.Viewer, "_compile_posed_pipeline", slow)
        _get(v, "/cmd?c=f_globe%20trism")
        _, h2, b2 = _get(v, "/frame.png?i=0")
        assert "[compiling posed pipeline]" in h2["X-Status"] and b2 == b1
        deadline = time.time() + 60
        while time.time() < deadline:
            _, h3, b3 = _get(v, "/frame.png?i=0")
            if "[compiling posed pipeline]" not in h3["X-Status"]:
                break
            time.sleep(0.05)
        assert "[compiling posed pipeline]" not in h3["X-Status"] and b3 != b1
        ref = _np(sess.render_posed(frames[0][..., None], np.asarray([[0.0, 30.0, 0.0]])))[0]
        np.testing.assert_array_equal(decode_png(b3), sess.palette[ref])
    finally:
        v.stop()


def test_state_drains_console_only_with_token():
    sess = Session(64, 48, platesize=32, device="cpu")
    v = Viewer(sess, np.stack([synthetic_cubemap(32)]))
    v.start()
    try:
        sess.cmd("echo hello-from-test")
        _, _, body = _get(v, "/state")
        assert json.loads(body)["console"] == []
        _, _, body = _get(v, f"/state?t={v.token}")
        assert any("hello-from-test" in ln for ln in json.loads(body)["console"])
        _, _, body = _get(v, f"/state?t={v.token}")
        assert json.loads(body)["console"] == []
    finally:
        v.stop()


def test_follow_small_angles_fixed_point():
    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)] * 2)
    poses = np.array([[0.0, 0.0, 0.0], [6.104e-05, 0.0, 0.0]], np.float32)
    v = Viewer(sess, frames, poses=poses)
    v.start()
    try:
        _get(v, "/frame.png?i=1&follow=1")
        assert abs(sess.view_angles[0] - 6.104e-05) < 1e-7
        va = sess.view_angles
        _get(v, "/frame.png?i=1&follow=1")
        assert sess.view_angles == va
    finally:
        v.stop()


def test_endpoint_fuzz_server_survives():
    import random
    from urllib.error import URLError

    rng = random.Random(0xB111)
    sess = Session(48, 36, platesize=16, device="cpu")
    v = Viewer(sess, np.stack([synthetic_cubemap(16)] * 2), poses=np.zeros((2, 3), np.float32))
    v.start()
    try:
        paths = ["/", "/frame.png", "/state", "/cmd", "/key", "/record.gif",
                 "/favicon.ico", "/..", "/%zz", "/nope"]
        verbs = ["f_lens", "f_globe", "f_fov", "f_vfov", "f_cover", "f_contain", "f_rubix",
                 "f_rubixgrid", "fisheye", "setviewangles", "bind", "echo", "wait", "alias"]
        junk = "%00%ff%%%20&&==??//\\'\"<>~`"
        for _ in range(150):
            path = rng.choice(paths)
            params = []
            for _ in range(rng.randrange(4)):
                k = rng.choice(["i", "c", "k", "t", "follow", "fast", "d", rng.choice("abcxyz")])
                val = rng.choice([
                    str(rng.randrange(-9, 9)), str(rng.randrange(10**9)), "zap", "", "1e309",
                    "nan", "".join(rng.choices(junk, k=rng.randrange(1, 9))),
                    f"{rng.choice(verbs)}%20" + "".join(rng.choices("abc0.-%20",
                                                                  k=rng.randrange(8))),
                ])
                if k == "t" and rng.random() < 0.5:
                    val = v.token
                params.append(f"{k}={val}")
            if params:
                path += "?" + "&".join(params)
            try:
                with urlopen(v.address + path, timeout=60) as r:
                    assert r.status == 200
            except HTTPError as e:
                assert e.code in (400, 403, 404, 500)
            except (URLError, TimeoutError) as e:  # pragma: no cover
                raise AssertionError(f"server died on {path!r}: {e}")
        assert _status(v, "/frame.png?i=0") == 200
        assert tuple(sess.render(v.frames[0]).shape) == (36, 48)
    finally:
        v.stop()


def test_pose_scale_validated_at_construction():
    sess = Session(64, 48, platesize=32, device="cpu")
    frames = np.stack([synthetic_cubemap(32)])
    for bad in ("bogus", 1.5, True, 0, -2, 5):
        with pytest.raises(ValueError):
            Viewer(sess, frames, pose_scale=bad)
    Viewer(sess, frames, pose_scale=2)
    Viewer(sess, frames, pose_scale="auto")


def test_failed_posed_warm_backs_off_and_retries(monkeypatch):
    import blinky_tpu_torch.viewer as viewer_mod

    sess, frames, v = _eckert1_viewer()
    out1 = v._render_posed_frame(0)
    real = viewer_mod.Viewer._compile_posed_pipeline
    calls = []

    def flaky(self, *a, **kw):
        calls.append(a)
        if len(calls) == 1:
            raise RuntimeError("transient device error")
        return real(self, *a, **kw)

    monkeypatch.setattr(viewer_mod.Viewer, "_compile_posed_pipeline", flaky)
    sess.cmd("f_globe trism")
    np.testing.assert_array_equal(v._render_posed_frame(0), out1)
    pk = v._posed_pipeline_key(v._posed_source(0))
    deadline = time.monotonic() + 10
    while pk in v._posed_warming and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pk not in v._posed_warm_keys and pk not in v._posed_warming
    assert v._posed_warm_retry_at.get(pk, 0) > time.monotonic()
    np.testing.assert_array_equal(v._render_posed_frame(0), out1)
    assert len(calls) == 1 and pk not in v._posed_warming
    v._posed_warm_retry_at[pk] = time.monotonic() - 1
    v._render_posed_frame(0)
    deadline = time.monotonic() + 30
    while pk not in v._posed_warm_keys and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(calls) == 2 and pk in v._posed_warm_keys
    assert pk not in v._posed_warm_retry_at
    out4 = v._render_posed_frame(0)
    ref = _np(sess.render_posed(v._posed_source(0), np.asarray([[0.0, 30.0, 0.0]])))[0]
    np.testing.assert_array_equal(out4, ref)


def test_deterministic_posed_warm_failure_surfaces_inline(monkeypatch):
    import blinky_tpu_torch.viewer as viewer_mod

    sess, frames, v = _eckert1_viewer()
    out1 = v._render_posed_frame(0)

    def boom(self, *a, **kw):
        raise RuntimeError("pipeline build broken")

    monkeypatch.setattr(viewer_mod.Viewer, "_compile_posed_pipeline", boom)
    sess.cmd("f_globe trism")
    pk = v._posed_pipeline_key(v._posed_source(0))
    for _ in range(v.POSED_WARM_MAX_FAILS):
        np.testing.assert_array_equal(v._render_posed_frame(0), out1)
        deadline = time.monotonic() + 10
        while pk in v._posed_warming and time.monotonic() < deadline:
            time.sleep(0.01)
        v._posed_warm_retry_at[pk] = time.monotonic() - 1
    assert v._posed_warm_fails[pk] == v.POSED_WARM_MAX_FAILS
    real_rp = sess.render_posed
    monkeypatch.setattr(sess, "render_posed",
                        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("pipeline build broken")))
    with pytest.raises(RuntimeError, match="pipeline build broken"):
        v._render_posed_frame(0)
    monkeypatch.setattr(sess, "render_posed", real_rp)
    out_live = v._render_posed_frame(0)
    assert pk in v._posed_warm_keys and pk not in v._posed_warm_fails
    ref = _np(real_rp(v._posed_source(0), np.asarray([[0.0, 30.0, 0.0]])))[0]
    np.testing.assert_array_equal(out_live, ref)


def test_expired_warm_join_refuses_concurrent_inline_render(monkeypatch):
    import blinky_tpu_torch.viewer as viewer_mod

    sess, frames, v = _eckert1_viewer()
    out1 = v._render_posed_frame(0)
    real = viewer_mod.Viewer._compile_posed_pipeline
    started, gate = threading.Event(), threading.Event()

    def slow(self, *a, **kw):
        started.set()
        assert gate.wait(30)
        return real(self, *a, **kw)

    monkeypatch.setattr(viewer_mod.Viewer, "_compile_posed_pipeline", slow)
    sess.cmd("f_globe trism")
    np.testing.assert_array_equal(v._render_posed_frame(0), out1)
    assert started.wait(10)
    v.POSED_JOIN_TIMEOUT = 0.05
    rendered = []
    monkeypatch.setattr(type(sess), "render_posed", lambda *a, **kw: rendered.append(True))
    with pytest.raises(RuntimeError, match="still running"):
        v._render_posed_frame(0, block=True)
    assert rendered == []
    gate.set()
    t = v._posed_warming.get(v._posed_pipeline_key(v._posed_source(0)))
    if t is not None:
        t.join(10)
    monkeypatch.undo()
