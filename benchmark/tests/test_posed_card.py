"""The posed cell, ``pc1080.posed_card``, rehearsed through the harness on
the CPU at the shared tiny size: its screens counted one a frame, its
faults caught, its readers (``k6_roofline``, ``k7_roofline``,
``posed_upload_ms``) on synthetic traces and on a traced run, and the
counts they read."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, k6_ops, k7_bytes, rooflines, trace
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX
from blinky_tpu_torch import api

SPEC = harness.benchmark_spec()
CELL = "pc1080.posed_card"


def _run(traced=False, seed=2**31 + 3):
    return harness.run_cell(SPEC, CELL, seed, 0.3, traced, device="cpu",
                            t_start=time.perf_counter(), cfg_override=SMALL_CFG,
                            mix_override={**SMALL_MIX, "trace_seconds": 0.1})


def test_a_call_counts_one_screen_a_frame():
    res, run = _run()
    assert res["correct"] is True, res["checks"]
    assert run.calls == res["attempted"] > 0
    assert run.screens == run.calls * SMALL_MIX["batch"] != run.calls * SMALL_CFG["width"]
    assert set(res["metrics"]) == {"setup_s", "screens_per_s"}


def test_a_call_is_given_its_slots_bases_made_in_set_up(monkeypatch):
    """Each call passes the float32 bases that set-up put on the device,
    the same tensor every time its slot comes round: nothing to upload."""
    seen = []
    orig = api.Session.render_posed
    monkeypatch.setattr(api.Session, "render_posed",
                        lambda self, frames, bases, **k: seen.append(bases)
                        or orig(self, frames, bases, **k))
    _, run = _run()
    given = run.state["given"]
    assert len(seen) == run.calls + len(given)  # the warm-up, then the window
    for i, b in enumerate(seen):
        assert b is given[i % len(given)]
        assert b.dtype == torch.float32 and b.shape == (SMALL_MIX["batch"], 3, 3)
    assert all(np.array_equal(g.numpy(), b.astype(np.float32))
               for g, b in zip(given, run.state["bases"]))


def test_the_check_states_the_kernels_counts():
    _, run = _run()
    W, H, S = (SMALL_CFG[k] for k in ("width", "height", "platesize"))
    B = SMALL_MIX["batch"]
    assert run.facts == {"k6_ops": 86 * W * H * B, "k7_bytes": 2 * 6 * S * S * B}


def test_a_traced_run_reads_the_upload_span():
    res, run = _run(traced=True)
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    assert m["posed_upload_ms"]["unit"] == "ms" and m["posed_upload_ms"]["value"] > 0
    assert m["rebuilds_in_window"]["value"] == 0
    # no kernel records on the CPU: the device's metrics stay silent
    assert not {"k6_roofline", "k7_roofline", "device_idle_pct.throughput"} & set(m)
    names = {s.name for s in run.trace.spans}
    assert {"bench.render", "session.render_posed", "posed.upload"} <= names
    assert "posed.bases" not in names  # the bases were made in set-up


def _half_batch(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _shifted_row(out):
    out = out.clone()
    out[0] = torch.roll(out[0], 1, dims=0)
    return out


@pytest.mark.parametrize("fault", [_half_batch, _shifted_row])
def test_an_output_fault_is_caught(monkeypatch, fault):
    orig = api.Session.render_posed
    monkeypatch.setattr(api.Session, "render_posed",
                        lambda self, *a, **k: fault(orig(self, *a, **k)))
    assert _run()[0]["correct"] is False


def _neighbours_pose(bases):
    out = bases.clone()
    out[1:] = bases[:-1]
    return out


def _transposed(bases):
    return bases.transpose(-1, -2).contiguous()


@pytest.mark.parametrize("fault", [_neighbours_pose, _transposed])
def test_a_pose_fault_is_caught(monkeypatch, fault):
    orig = api.Session.render_posed
    monkeypatch.setattr(api.Session, "render_posed",
                        lambda self, frames, bases, **k: orig(self, frames, fault(bases), **k))
    assert _run()[0]["correct"] is False


# ------------------------------------------------------------ the readers


def _span(name, ts, dur, cat="user_annotation"):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


class _Run:
    def __init__(self, events, facts=None):
        self.trace = trace.from_events(events)
        self.facts = facts or {}


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


WINDOW = _span(trace.WINDOW, 1000, 1000)  # microseconds 1000-2000


def _calls():
    return [
        WINDOW,
        # cut by the window's start: left out
        _span("session.render_posed", 950, 100), _span("posed.upload", 955, 60),
        # call 1: an upload of 300 us
        _span("session.render_posed", 1100, 400), _span("posed.upload", 1110, 300),
        _span("launch.posed_layout", 1420, 20), _span("launch.static_ray_posed", 1450, 20),
        # call 2: a chunked call, two nested calls of 40 and 60 us of upload
        _span("session.render_posed", 1550, 200),
        _span("session.render_posed", 1560, 80), _span("posed.upload", 1565, 40),
        _span("session.render_posed", 1650, 90), _span("posed.upload", 1655, 60),
        # call 3: 20 us
        _span("session.render_posed", 1800, 100), _span("posed.upload", 1805, 20),
        # cut by the window's end: left out
        _span("session.render_posed", 1950, 100), _span("posed.upload", 1960, 30),
        _span("void (anonymous namespace)::posed_layout_tile(x)", 1420, 120, "kernel"),
        _span("void (anonymous namespace)::static_ray_posed_kernel<1>(x)", 1550, 250,
              "kernel"),
        _span("void (anonymous namespace)::static_ray_posed_kernel<1>(x)", 1900, 200,
              "kernel"),  # cut by the window's end: left out
    ]


def test_posed_upload_ms_is_the_median_upload_a_call():
    # calls: 300, 40 + 60, 20 us -> median 100 us
    assert _read("posed_upload_ms", _Run(_calls())) == pytest.approx(0.100)


def test_posed_upload_ms_reads_nothing_without_the_span():
    """The parent's program has no ``posed.upload``: no value, no error."""
    ev = [e for e in _calls() if e["name"] != "posed.upload"]
    assert _read("posed_upload_ms", _Run(ev)) is None
    run = _Run(ev)
    run.trace = None
    assert _read("posed_upload_ms", run) is None


def test_kernel_rooflines_read_whole_records():
    facts = {"k6_ops": rooflines.FP32_OPS_PER_S * 100e-6,
             "k7_bytes": rooflines.HBM_BYTES_PER_S * 60e-6}
    run = _Run(_calls(), facts)
    assert _read("k6_roofline", run) == pytest.approx(100.0 * 100e-6 / 250e-6)
    assert _read("k7_roofline", run) == pytest.approx(100.0 * 60e-6 / 120e-6)
    assert _read("k6_roofline", _Run(_calls())) is None  # no count from the check
    run.trace = None
    assert _read("k7_roofline", run) is None


def test_the_counts_are_the_kernel_tables():
    # K6 at 1080p, B = 64 on the cube: 86 operations a pose and ray, the
    # kernel table's 11,413,094,400; K7: 895,795,200 bytes
    assert k6_ops.per_ray(6) == 86
    assert k6_ops.ops(1920 * 1080, 64, 6) == 11_413_094_400
    assert k7_bytes.nbytes(6, 1080, 64) == 895_795_200
    # the cell's call: B = 1024
    assert k7_bytes.nbytes(6, 1080, 1024) / rooflines.HBM_BYTES_PER_S == pytest.approx(
        4.2784e-3, rel=1e-4)
