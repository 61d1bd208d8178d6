"""The program's spans (``blinky_tpu_torch.utils.timing.span``) on the CPU.

With no profiler recording, a span is one shared null context and enters
no ``record_function``.  Under ``torch.profiler`` each span is a
``user_annotation`` range of the Chrome trace, nested in the span it was
opened in: the Session's entry (``session.*``), each rebuild of a table or
kernel object (``build.*``), the host steps of the posed and replay paths.
The kernel launches (``launch.*``) exist only on a card: here the helper
that makes them is driven with a stand-in library, and
tests/test_torch_cuda.py traces K1's.
"""

import ast
import inspect
import json
import textwrap

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blinky_tpu_torch import native
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench.__main__ import kernel_wrappers
from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
from blinky_tpu_torch.io.dataset import FrameBatchIterator
from blinky_tpu_torch.kernels import _build
from blinky_tpu_torch.utils import timing

W, H, S = 64, 48, 48


def _raise(*a, **k):
    raise AssertionError("record_function entered with no profiler recording")


def _spans(events):
    """(name, start, end, tid) of each user_annotation range, by start."""
    out = [(e["name"], e["ts"], e["ts"] + e["dur"], e.get("tid"))
           for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _traced(fn, tmp_path, name="t.json"):
    """Run *fn* under a CPU profile; its user_annotation ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / name
    prof.export_chrome_trace(str(path))
    return _spans(json.loads(path.read_text())["traceEvents"])


def _inside(spans, outer):
    """The names of the spans nested in *outer* on its thread."""
    _, a, b, tid = outer
    return sorted(n for n, s, e, t in spans
                  if t == tid and a <= s and e <= b and (n, s, e, t) != outer)


def _calls(spans, name):
    return [s for s in spans if s[0] == name]


def test_unrecorded_span_is_the_shared_null_context(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    a, b = timing.span("session.render"), timing.span("launch.remap_gather")
    assert a is b
    with a:
        with b:
            pass
    t = timing.Timings()
    with t.stage("pack"):
        pass
    assert t.counts == {"pack": 1}


def test_unrecorded_session_calls_enter_no_record_function(monkeypatch):
    """A whole render and an equirect render, first calls (every rebuild)
    and second calls, with ``record_function`` made to raise."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    sess = Session(W, H, device="cpu")
    frames = synthetic_cubemap_batch(S, 2)
    for _ in range(2):
        assert sess.render(frames).shape == (H, W, 2)
    panos = np.random.default_rng(0).integers(0, 2**32, (32, 64, 2), dtype=np.uint64)
    for _ in range(2):
        assert sess.render_equirect(panos.astype(np.uint32)).shape == (H, W, 2)


def test_spanned_keeps_the_function_and_spans_each_call(tmp_path):
    @timing.spanned("build.thing")
    def thing(a, *, b=2):
        """doc"""
        return a + b

    assert (thing.__name__, thing.__doc__) == ("thing", "doc")
    assert str(inspect.signature(thing)) == "(a, *, b=2)"
    assert thing(1) == 3
    spans = _traced(lambda: (thing(1), thing(2, b=0)), tmp_path)
    assert [n for n, *_ in spans] == ["build.thing"] * 2


def test_recorded_span_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = timing.span("build.lensmap")
        assert isinstance(s, torch.profiler.record_function)
    assert timing.span("build.lensmap") is timing.span("x")


def test_session_render_spans_nest_the_first_calls_rebuilds(tmp_path):
    sess = Session(W, H, device="cpu")
    frames = synthetic_cubemap_batch(S, 2)
    spans = _traced(lambda: (sess.render(frames), sess.render(frames)), tmp_path)
    first, second = _calls(spans, "session.render")
    inner = _inside(spans, first)
    assert {"build.lensmap", "build.remap_kernel"} <= set(inner), inner
    assert all(n.startswith("build.") for n in inner), inner
    assert _inside(spans, second) == []


def test_session_render_equirect_spans_nest_its_rebuilds(tmp_path):
    sess = Session(W, H, platesize=16, device="cpu")
    panos = np.random.default_rng(1).integers(0, 2**32, (32, 64, 2),
                                              dtype=np.uint64).astype(np.uint32)
    spans = _traced(lambda: [sess.render_equirect(panos) for _ in range(2)], tmp_path)
    first, second = _calls(spans, "session.render_equirect")
    inner = _inside(spans, first)
    assert {"build.ingest", "build.compact_chain", "build.lensmap",
            "build.remap_kernel"} <= set(inner), inner
    assert _inside(spans, second) == []
    # the faces mode renders the faces through render(): one entry inside another
    spans = _traced(lambda: sess.render_equirect(panos, mode="faces"), tmp_path, "f.json")
    (outer,) = _calls(spans, "session.render_equirect")
    assert "session.render" in _inside(spans, outer)


@pytest.mark.parametrize("source", ["tensor", "numpy", "rgba"])
def test_session_render_aa_spans_hold_the_decode_and_the_render(tmp_path, source):
    """``session.render_aa`` is the outermost span of a call; inside it,
    ``aa.decode`` around the decode of u8 frames held as a tensor (a NumPy
    batch decodes on the host, packed RGBA needs none) and the supersampled
    session's ``session.render``, with the first call's rebuilds."""
    sess = Session(W, H, platesize=S, device="cpu")
    frames = synthetic_cubemap_batch(S, 2)
    if source == "tensor":
        frames = torch.from_numpy(frames)
    elif source == "rgba":
        from blinky_tpu_torch.kernels.remap import frames_to_rgba

        frames = frames_to_rgba(frames, sess.palette)
    spans = _traced(lambda: [sess.render_aa(frames, factor=2) for _ in range(2)], tmp_path)
    first, second = _calls(spans, "session.render_aa")
    assert len(_calls(spans, "aa.decode")) == (2 if source == "tensor" else 0)
    for outer in (first, second):
        inner = _inside(spans, outer)
        assert inner.count("session.render") == 1
        assert inner.count("aa.decode") == (1 if source == "tensor" else 0)
    assert {"build.lensmap", "build.remap_kernel"} <= set(_inside(spans, first))
    assert not any(n.startswith("build.") for n in _inside(spans, second))


def test_render_posed_and_the_lens_stage_spans(tmp_path):
    sess = Session(W, H, device="cpu", backend="torch")
    frames = synthetic_cubemap_batch(S, 2)
    poses = np.array([[0.0, 10.0, 0.0], [5.0, -20.0, 3.0]])
    spans = _traced(lambda: (sess.render_posed(frames, poses),
                             sess.render_posed(frames, poses)), tmp_path)
    first, second = [s for s in _calls(spans, "session.render_posed")
                     if not any(o[1] < s[1] and s[2] <= o[2]
                                for o in _calls(spans, "session.render_posed"))]
    assert {"posed.bases", "posed.upload"} <= set(_inside(spans, first))
    assert "lensmap.lens_stage" in _inside(spans, first)
    assert _inside(spans, second) == ["posed.bases", "posed.upload"]
    # the float32 device builder's lens stage inside a rotated view's build
    sess.cmd("setviewangles 10 30 0")
    spans = _traced(lambda: sess.render(frames), tmp_path, "r.json")
    (build,) = _calls(spans, "build.lensmap")
    assert "lensmap.lens_stage" in _inside(spans, build)


def test_render_posed_upload_span_under_profile_trace(tmp_path):
    """Bases given as ``[B, 3, 3]``: each call's upload is a ``posed.upload``
    span inside its ``session.render_posed``, and no ``posed.bases``."""
    sess = Session(W, H, device="cpu")
    frames = synthetic_cubemap_batch(S, 2)
    bases = np.stack([np.eye(3)[[2, 0, 1]]] * 2)
    with timing.profile_trace(str(tmp_path / "trace")):
        for _ in range(2):
            sess.render_posed(frames, bases)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    spans = _spans(json.loads(path.read_text())["traceEvents"])
    calls = _calls(spans, "session.render_posed")
    assert len(calls) == 2 and len(_calls(spans, "posed.upload")) == 2
    assert _inside(spans, calls[1]) == ["posed.upload"]
    assert "posed.bases" not in {n for n, *_ in spans}


def test_unrecorded_render_posed_enters_no_record_function(monkeypatch):
    """No profiler records: the upload's span is the one shared null
    context, and no ``record_function`` is entered."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert timing.span("posed.upload") is timing.span("session.render_posed")
    sess = Session(W, H, device="cpu")
    frames = synthetic_cubemap_batch(S, 2)
    for poses in (np.array([[0.0, 10.0, 0.0], [5.0, -20.0, 3.0]]),
                  np.stack([np.eye(3)[[2, 0, 1]]] * 2)):
        for _ in range(2):
            assert sess.render_posed(frames, poses).shape == (2, H, W)


def test_loader_spans(tmp_path):
    """The consumer's wait is a span on the profiled thread; the pack runs
    on the iterator's worker thread, which the profile does not record, and
    has no span of its own."""
    frames = np.zeros((5, 6, 8, 8), np.uint8)
    spans = _traced(lambda: list(FrameBatchIterator(frames, 2)), tmp_path)
    assert len(_calls(spans, "loader.wait")) == 4  # three batches and the end
    assert {n for n, *_ in spans} == {"loader.wait"}


def test_profile_trace_holds_the_program_spans_and_the_stages(tmp_path):
    sess = Session(W, H, device="cpu")
    frames = synthetic_cubemap_batch(S, 1)
    t = timing.Timings()
    with timing.profile_trace(str(tmp_path / "trace")):
        with t.stage("render"):
            sess.render(frames)
    (path,) = (tmp_path / "trace").glob("trace_*.json")
    spans = _spans(json.loads(path.read_text())["traceEvents"])
    (stage,) = _calls(spans, "render")
    (entry,) = _calls(spans, "session.render")
    assert "session.render" in _inside(spans, stage)
    assert {"build.lensmap", "build.remap_kernel"} <= set(_inside(spans, entry))
    assert t.counts == {"render": 1}


class _Lib:
    def __init__(self, rc):
        self.rc, self.calls = rc, 0

    def blinky_fake(self, x):
        self.calls += 1
        return self.rc

    def blinky_error_string(self, rc):
        return b"an error"


def _wrapper():
    pass


_wrapper.launches = 0


def test_launch_helper_spans_checks_and_counts(monkeypatch, tmp_path):
    lib = _Lib(0)
    monkeypatch.setattr(_wrapper, "launches", 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "_lib", lib)
    _build.launch(_wrapper, "fake", "blinky_fake", 1)
    spans = _traced(lambda: _build.launch(_wrapper, "fake", "blinky_fake", 2), tmp_path)
    assert [n for n, *_ in spans] == ["launch.fake"]
    assert lib.calls == 2 and _wrapper.launches == 2
    lib.rc = 700
    with pytest.raises(RuntimeError, match="_wrapper: CUDA error 700 at launch: an error"):
        _build.launch(_wrapper, "fake", "blinky_fake", 3)
    assert _wrapper.launches == 2  # a failed launch is not counted


def test_kernel_library_bind_is_a_span(monkeypatch, tmp_path):
    """The first bind of the kernel library (nvcc included when stale) is
    ``build.kernel_library``; a bound library is not bound again."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_build", lambda: None)

    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    spans = _traced(lambda: (_build.library(), _build.library()), tmp_path)
    assert [n for n, *_ in spans] == ["build.kernel_library"]


def test_native_library_bind_is_a_span(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_and_bind", lambda: None)
    spans = _traced(lambda: (native._load(), native._load()), tmp_path)
    assert [n for n, *_ in spans] == ["build.native_library"]


def _launch_names(fn):
    """(wrapper, span name) of each ``_build.launch`` call in *fn*'s source;
    a name given as a local variable is resolved to the string it holds."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    strings = {t.id: n.value.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
               for t in n.targets if isinstance(t, ast.Name)
               and isinstance(n.value, ast.Constant) and isinstance(n.value.value, str)}
    out = []
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "launch"):
            wrapper, name = n.args[:2]
            out.append((wrapper.id, name.value if isinstance(name, ast.Constant)
                        else strings[name.id]))
    return out


@pytest.mark.parametrize("key", sorted(kernel_wrappers()))
def test_each_wrapper_launches_under_its_kernels_name(key):
    """Every launch of the 13 wrappers goes through ``_build.launch`` with
    the wrapper's own counter and the span ``launch.<key>``, *key* the
    kernel's name in the bench suite's kernels line."""
    fn = kernel_wrappers()[key]
    found = _launch_names(fn)
    assert found and all(f == (fn.__name__, key) for f in found), found
