"""Bind-first cold serve in the port, with tests/test_cold_serve.py as the
model: the host remap path and its bit-equality with the kernels' path,
``Session.render_host``'s never-touch-the-device contract, and the
viewer's warm lifecycle (a slow warm, a failed warm with its backoff, retry
and the ``device_error`` that ``/state`` now carries, the posed warm, and
``cli serve --no-warm``).  Tolerance 0 against the JAX package's host
functions; the rotated view of ``render`` (the float32 builder) against
``render_host`` (the exact one) by the JAX test's own 0.02.
"""

import json
import threading
import time
from urllib.request import urlopen

import numpy as np
import pytest
import torch

from blinky_tpu.kernels.remap import host_remap as jhost_remap
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.kernels.remap import (
    RemapKernel, expand_frames_tinted, frames_to_rgba, host_remap,
)
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.palette import default_palette
from blinky_tpu_torch.viewer import Viewer

W, H, S = 64, 48, 48


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.cpu()
        return t.view(torch.int32).numpy().view(np.uint32) if t.dtype == torch.uint32 \
            else t.numpy()
    return np.asarray(t)


@pytest.fixture(scope="module")
def lm():
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    return build_lensmap(lens, g, calc_scale(Zoom("fov", 180), lens, W, H), W, H, S)


def test_host_remap_bit_equals_device_kernel(lm):
    pal = default_palette()
    frame = synthetic_cubemap(S)
    bg = np.full((H, W), 9, np.uint8)
    k = RemapKernel(lm, pal, bg, device="cpu")
    for src, kw in ((frame, {}), (frame, dict(rubix=True)), (frame, dict(decode_rgb=True)),
                    (expand_frames_tinted(frame, pal), dict(rubix=True)),
                    (frames_to_rgba(frame, pal), {}),
                    (frames_to_rgba(frame, pal), dict(rubix=True))):
        got = host_remap(lm, src, pal, bg, **kw)
        np.testing.assert_array_equal(got, _np(k(src, **kw)), err_msg=str(kw))
        np.testing.assert_array_equal(got, jhost_remap(lm, src, pal, bg, **kw), err_msg=str(kw))


def test_host_remap_partial_globe_and_errors(lm):
    pal = default_palette()
    g = globes.get("fast")
    lens = lenses.get("panini", g)
    lm2 = build_lensmap(lens, g, calc_scale(Zoom("fov", 140), lens, W, H), W, H, S)
    frame = synthetic_cubemap(S)[:2]
    k = RemapKernel(lm2, pal, device="cpu")
    padded = np.concatenate([frame, np.zeros((4,) + frame.shape[1:], np.uint8)])
    np.testing.assert_array_equal(host_remap(lm2, padded, pal), _np(k(frame)))
    with pytest.raises(ValueError, match="palette"):
        host_remap(lm, frame, None, rubix=True)
    with pytest.raises(ValueError, match="frame"):
        host_remap(lm, frame[..., None])


def test_session_render_host_matches_render():
    frame = synthetic_cubemap(S)
    a = Session(W, H, platesize=S, device="cpu")
    b = Session(W, H, platesize=S, device="cpu")
    for cmds in ([], ["f_rubix 1"], ["f_lens hammer"], ["setviewangles 10 25 0"],
                 ["fisheye 0"]):
        for c in cmds:
            a.cmd(c)
            b.cmd(c)
        hostout = _np(a.render_host(frame))
        devout = _np(b.render(frame))
        if cmds == ["setviewangles 10 25 0"]:
            assert (hostout != devout).mean() < 0.02
        else:
            np.testing.assert_array_equal(hostout, devout)


def test_session_render_host_is_device_free(monkeypatch):
    """The whole cold path (construction, commands, rebuild, render_host)
    of a session on the card never makes a device table or kernel: here,
    where there is no card, it runs on a ``device="cuda"`` session."""
    import blinky_tpu_torch.api as api_mod

    def boom(*a, **k):
        raise AssertionError("device touched on the cold path")

    monkeypatch.setattr(api_mod, "RemapKernel", boom)
    monkeypatch.setattr(torch.Tensor, "cuda", boom)
    sess = Session(W, H, platesize=S, device="cuda")
    sess.cmd("f_lens hammer; f_rubix 1")
    frame = synthetic_cubemap(S)
    assert host_remap(sess.lensmap, frame, sess.palette, rubix=True).shape == (H, W)
    assert np.asarray(sess.render_host(frame)).shape == (H, W)
    sess.cmd("f_lens winkeltripel")
    sess.build_budget_s = 1 / 240
    assert np.asarray(sess.render_host(frame)).shape == (H, W)


def _state(v):
    with urlopen(v.address + "/state", timeout=10) as r:
        return json.loads(r.read())


def test_viewer_cold_serve_with_mocked_slow_device(monkeypatch):
    import blinky_tpu_torch.lensmap as lensmap_mod

    sess = Session(W, H, platesize=32, device="cpu")
    v = Viewer(sess, synthetic_cubemap(32)[None], device_warm=False)
    real_build = lensmap_mod.build_lensmap
    started = threading.Event()

    def slow_build(*a, **k):
        started.set()
        time.sleep(1.0)
        return real_build(*a, **k)

    monkeypatch.setattr(lensmap_mod, "build_lensmap", slow_build)
    real_render = Session.render
    monkeypatch.setattr(Session, "render", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("device render during cold phase")))
    v.start()
    try:
        t = v.start_background_warm()
        started.wait(5)
        t0 = time.perf_counter()
        with urlopen(v.address + "/frame.png?i=0", timeout=10) as r:
            assert r.status == 200 and "device warming" in r.headers["X-Status"]
        assert time.perf_counter() - t0 < 1.0
        st = _state(v)
        assert st["device_ready"] is False and st["device_error"] == ""
        t.join(30)
        assert v.device_ready.is_set() and _state(v)["device_ready"] is True
        monkeypatch.setattr(Session, "render", real_render)
        with urlopen(v.address + "/frame.png?i=0", timeout=30) as r:
            assert r.status == 200 and "device warming" not in r.headers.get("X-Status", "")
    finally:
        v.stop()


def test_viewer_stays_on_host_when_warm_fails(monkeypatch, capsys):
    import blinky_tpu_torch.lensmap as lensmap_mod

    sess = Session(W, H, platesize=32, device="cpu")
    v = Viewer(sess, synthetic_cubemap(32)[None], device_warm=False)
    monkeypatch.setattr(lensmap_mod, "build_lensmap", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("card lost")))
    v.start()
    try:
        v.start_background_warm().join(10)
        assert not v.device_ready.is_set()
        # visible: printed, and on /state beside device_ready
        assert "device warm failed (RuntimeError: card lost)" in capsys.readouterr().out
        st = _state(v)
        assert st["device_ready"] is False and st["device_error"] == "RuntimeError: card lost"
        with urlopen(v.address + "/frame.png?i=0", timeout=10) as r:
            assert r.status == 200
    finally:
        v.stop()


def test_warm_failure_retries_after_backoff(monkeypatch):
    import blinky_tpu_torch.lensmap as lensmap_mod

    sess = Session(W, H, platesize=32, device="cpu")
    v = Viewer(sess, synthetic_cubemap(32)[None], device_warm=False)
    real = lensmap_mod.build_lensmap
    fail = {"on": True}

    def flaky(*a, **k):
        if fail["on"]:
            raise RuntimeError("card lost")
        return real(*a, **k)

    monkeypatch.setattr(lensmap_mod, "build_lensmap", flaky)
    v.start()
    try:
        t = v.start_background_warm()
        t.join(10)
        assert not v.device_ready.is_set() and v.device_error
        assert v._warm_retry_at > time.monotonic() + 20  # the 30 s backoff
        with urlopen(v.address + "/frame.png?i=0", timeout=10) as r:
            assert r.status == 200
        assert v._warm_thread is t
        fail["on"] = False
        v._warm_retry_at = 0.0
        with urlopen(v.address + "/frame.png?i=0", timeout=10) as r:
            assert r.status == 200
        assert v._warm_thread is not t
        assert v.device_ready.wait(30)
        v._warm_thread.join(10)
        assert _state(v)["device_error"] == ""  # cleared by the warm that landed
    finally:
        v.stop()


def test_background_warm_covers_posed_pipeline_for_forward_lens():
    sess = Session(W, H, platesize=32, device="cpu")
    sess.cmd("f_lens eckert1")
    v = Viewer(sess, synthetic_cubemap(32)[None], device_warm=False)
    assert not v._posed_warm_keys
    v.start_background_warm().join(120)
    assert v.device_ready.is_set()
    # the posed pipeline ran once for the drag-look's key, on the warm's
    # own kernel objects; the session itself was not touched
    src = v.frames[0][..., None]
    assert v._posed_pipeline_key(src) in v._posed_warm_keys
    assert sess.view_angles is None and sess._posed_cache is None


def test_warm_thread_enters_the_card_through_the_wrappers_helper(monkeypatch):
    """The warm threads reach a card through ``kernels._build.on_device``,
    the helper every kernel wrapper launches inside; a CPU session needs
    none."""
    import contextlib

    from blinky_tpu_torch import viewer as viewer_mod
    from blinky_tpu_torch.kernels import _build

    seen = []
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: (seen.append(dev), contextlib.nullcontext())[1])
    with viewer_mod._entered(torch.device("cuda", 1)):
        pass
    with viewer_mod._entered(torch.device("cpu")):
        pass
    assert seen == [torch.device("cuda", 1)]


def test_cli_no_warm_starts_device_live(monkeypatch):
    import blinky_tpu_torch.viewer as viewer_mod
    from blinky_tpu_torch import cli

    seen = {}

    class StubViewer:
        def __init__(self, sess, frames, poses=None, host="", port=0, device_warm=True,
                     pose_scale=1):
            seen["device_warm"] = device_warm
            seen["device"] = sess.device
            seen.pop("warmed", None)
            self.address = "http://stub"

        def start_background_warm(self):
            seen["warmed"] = True

        def serve_forever(self):
            return

    monkeypatch.setattr(viewer_mod, "Viewer", StubViewer)
    assert cli.main(["serve", "--no-warm", "--platesize", "32", "--device", "cpu"]) == 0
    assert seen["device_warm"] is True and "warmed" not in seen
    assert seen["device"] == torch.device("cpu")
    assert cli.main(["serve", "--platesize", "32", "--device", "cpu"]) == 0
    assert seen["device_warm"] is False and seen["warmed"] is True
