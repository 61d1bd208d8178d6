"""The script-globe cell, ``lfast.posed_card``, rehearsed through the harness
on the CPU at the shared tiny size: its globe found through ``globe_dirs``,
its spans traced, its control and faults caught, its readers
(``script_plates_ms``, ``script_pieces``, ``k13_roofline``; ``k6_roofline``
on mode 2's count) on synthetic traces, and the counts they read; on a
card, one traced run at the cell's own size."""

import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, k6_ops_given, k13_bytes, rooflines, trace
from benchmark.drivers import posed_script
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX
from blinky_tpu_torch import api
from blinky_tpu_torch.bench import lua_drop_ins

SPEC = harness.benchmark_spec()
CELL = "lfast.posed_card"


def _run(traced=False, seed=2**31 + 3, device="cpu", seconds=0.3, small=True):
    return harness.run_cell(SPEC, CELL, seed, seconds, traced, device=device,
                            t_start=time.perf_counter(),
                            cfg_override=SMALL_CFG if small else None,
                            mix_override={**SMALL_MIX, "trace_seconds": 0.1} if small else None)


def test_the_configuration_holds_the_drop_in_script():
    _, cfg, mix = harness.resolve(SPEC, CELL)
    assert cfg["script"] == lua_drop_ins.LFAST and cfg["globe"] == "lfast"
    assert cfg["planes"] == 2 and cfg["reduced"] == [] and mix["driver"] == "posed_script"
    sources = [c["source"] for c in SPEC["configs"]]
    assert len(set(sources)) == len(sources)


@pytest.mark.parametrize("traced", [False, True])
def test_the_cell_rehearses_on_the_cpu(traced, monkeypatch):
    seen = []
    orig = api.Session.render_posed
    monkeypatch.setattr(api.Session, "render_posed",
                        lambda self, frames, bases, **k: seen.append(self) or orig(
                            self, frames, bases, **k))
    res, run = _run(traced)
    assert res["correct"] is True, res["checks"]
    assert run.calls == res["attempted"] > 0
    assert run.screens == run.calls * SMALL_MIX["batch"]
    sess = seen[0]
    assert sess.globe_name == "lfast" and sess.globe.plate_resolver is not None
    assert all(s is sess for s in seen)
    S = SMALL_CFG["platesize"]
    assert all(s.shape == (2, S, S, SMALL_MIX["batch"]) for s in run.state["src"])
    if not traced:
        assert set(res["metrics"]) == {"setup_s", "screens_per_s"}
        return
    names = {s.name for s in run.trace.spans}
    assert {"bench.render", "session.render_posed", "posed.upload", "posed.script_plates",
            "posed.script_piece"} <= names
    m = res["metrics"]
    assert m["script_pieces"]["value"] == 1 and m["rebuilds_in_window"]["value"] == 0
    # no kernel records on the CPU: the device's metrics stay silent
    assert not {"k6_roofline", "k13_roofline", "script_plates_ms",
                "device_idle_pct.throughput"} & set(m)


def test_the_globes_directory_is_removed_after_the_check():
    _, run = _run()
    assert "globe_dir" not in run.state


def test_the_limit_lies_under_the_control():
    """The control, the reference one precision down, reads above the limit
    on seeds other than the generic control test's; on the card it reads
    over three times the limit (PERF.md, section 2)."""
    _, _, mix = harness.resolve(SPEC, CELL)
    limit = mix["limits"]["screen_mismatch"]
    readings = list(control.readings(CELL, [4, 2**31 + 5, 2**33 + 6], 0.2, False, device="cpu",
                                     cfg_override=SMALL_CFG, mix_override=SMALL_MIX, spec=SPEC))
    assert all(r["screen_mismatch"] > limit for _, r in readings), readings


def test_the_frames_are_a_function_of_the_seed():
    a = posed_script.frame_batches(2, 8, 3, 2, 2**31 + 9, "cpu")
    b = posed_script.frame_batches(2, 8, 3, 2, 2**31 + 9, "cpu")
    c = posed_script.frame_batches(2, 8, 3, 2, 10, "cpu")
    assert a[0].shape == (2, 8, 8, 3) and a[0].dtype == torch.uint8
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])


# ------------------------------------------------------------- the faults


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


def test_a_lane_at_its_neighbours_pose_is_caught(monkeypatch):
    def shifted(bases):
        out = bases.clone()
        out[1:] = bases[:-1]
        return out

    orig = api.Session.render_posed
    monkeypatch.setattr(api.Session, "render_posed",
                        lambda self, frames, bases, **k: orig(self, frames, shifted(bases), **k))
    assert _run()[0]["correct"] is False


def test_the_cubes_plates_in_place_of_the_scripts_are_caught(monkeypatch):
    """The Session resolves by the built-in cube's max-dot select instead of
    the script: the frames' two plates read as the cube's front and right."""
    orig = api.Session.cmd
    monkeypatch.setattr(api.Session, "cmd", lambda self, line, *a, **k: orig(
        self, "f_globe cube" if line == "f_globe lfast" else line, *a, **k))
    res, run = _run()
    assert res["correct"] is False


# ------------------------------------------------------------ the counts


def test_the_check_states_the_kernels_counts():
    _, run = _run()
    W, H = SMALL_CFG["width"], SMALL_CFG["height"]
    B = SMALL_MIX["batch"]
    assert run.facts == {"k6_ops": 58 * W * H * B,
                         "k13_bytes": 12 * W * H + 36 * B + 12 * W * H * B}


def test_the_counts_are_the_kernel_tables():
    # PERF.md's kernel table at 1080p, B = 64: K6 in mode 2 7,697,203,200
    # operations (58 a pose and ray), K13 1,617,410,304 bytes
    assert k6_ops_given.PER_RAY == 58
    assert k6_ops_given.ops(1920 * 1080, 64) == 7_697_203_200
    assert k13_bytes.nbytes(1920 * 1080, 64) == 1_617_410_304
    # the cell's call, B = 1024: K13's bound 7.61 ms, K6's 3.68 ms
    assert k13_bytes.nbytes(1920 * 1080, 1024) / rooflines.HBM_BYTES_PER_S == pytest.approx(
        7.6135e-3, rel=1e-4)
    assert k6_ops_given.ops(1920 * 1080, 1024) / rooflines.FP32_OPS_PER_S == pytest.approx(
        3.6763e-3, rel=1e-4)


# ------------------------------------------------------------ the readers


def _span(name, ts, dur, cat="user_annotation"):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


class _Run:
    def __init__(self, events, facts=None):
        self.trace = trace.from_events(events)
        self.facts = facts or {}


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


K7 = "void (anonymous namespace)::posed_layout_rows<1, 2>(x)"
K13 = "void (anonymous namespace)::rotate_rays_kernel(x)"
K6 = "void (anonymous namespace)::static_ray_posed_kernel<unsigned char, 1, 2>(x)"
LIB = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_div(x)>",
       "void at::native::elementwise_kernel<128, 2, (x)>(int, (x))")


def _calls(lib=LIB, spans=True):
    """Two posed calls wholly inside the window (the second chunked: a
    nested call), each K7, two pieces of K13 and two library kernels, then
    K6; one cut by each edge."""
    ev = [_span(trace.WINDOW, 1000, 1000),
          # cut by the window's start: left out
          _span("session.render_posed", 950, 100), _span("posed.script_plates", 960, 50),
          _span("posed.script_piece", 965, 20)]
    for t0 in (1100, 1500):
        ev += [_span("session.render_posed", t0, 300),
               _span("posed.script_plates", t0 + 50, 100),
               _span("posed.script_piece", t0 + 55, 40), _span("posed.script_piece", t0 + 100, 40),
               _span(K7, t0, 40, "kernel"),
               _span(K13, t0 + 40, 10, "kernel"), _span(lib[0], t0 + 50, 20, "kernel"),
               _span(lib[1], t0 + 70, 10, "kernel"),
               _span(K13, t0 + 80, 10, "kernel"), _span(lib[0], t0 + 90, 20, "kernel"),
               _span(lib[1], t0 + 110, 10, "kernel"),
               _span(K6, t0 + 120, 100, "kernel")]
    ev.insert(6, _span("session.render_posed", 1510, 200))  # nested: not a call of its own
    ev += [_span("session.render_posed", 1950, 100), _span("posed.script_plates", 1960, 60),
           _span("posed.script_piece", 1965, 20), _span(K13, 1960, 60, "kernel")]
    return ev if spans else [e for e in ev if not e["name"].startswith("posed.script")]


def test_script_plates_ms_is_the_card_time_outside_k6_and_k7_a_call():
    # a call: two K13 of 10 us, four library kernels of 60 us in all; the
    # K13 record cut by the window's end adds its 40 us inside, over 2 calls
    assert _read("script_plates_ms", _Run(_calls())) == pytest.approx(
        1e-3 * (2 * 80 + 40) / 2)


def test_script_plates_ms_does_not_read_the_library_kernels_names():
    renamed = ("void fused_kernel_a(x)", "triton_poi_fused_div_1")
    assert _read("script_plates_ms", _Run(_calls(renamed))) == pytest.approx(
        _read("script_plates_ms", _Run(_calls())))


def test_script_pieces_is_the_median_pieces_a_call():
    assert _read("script_pieces", _Run(_calls())) == 2


def test_k13_and_k6_rooflines_read_their_records():
    facts = {"k13_bytes": rooflines.HBM_BYTES_PER_S * 10e-6,
             "k6_ops": rooflines.FP32_OPS_PER_S * 50e-6}
    run = _Run(_calls(), facts)
    # 2 calls of 10 us of bytes over 40 us of whole K13 records
    assert _read("k13_roofline", run) == pytest.approx(100.0 * 2 * 10e-6 / 40e-6)
    assert _read("k6_roofline", run) == pytest.approx(100.0 * 50e-6 / 100e-6)


@pytest.mark.parametrize("name", ["script_plates_ms", "script_pieces", "k13_roofline"])
def test_the_new_readers_read_nothing_without_the_spans(name):
    """The parent's program has no ``posed.script_*`` spans: no value, no
    error."""
    facts = {"k13_bytes": 1e6, "k6_ops": 1e6}
    assert _read(name, _Run(_calls(spans=False), facts)) is None
    run = _Run(_calls(), facts)
    run.trace = None
    assert _read(name, run) is None


def test_script_plates_ms_reads_nothing_without_a_device_record():
    ev = [e for e in _calls() if e["cat"] != "kernel"]
    assert _read("script_plates_ms", _Run(ev)) is None
    assert _read("k13_roofline", _Run(ev, {"k13_bytes": 1e6})) is None


# -------------------------------------------------------------- on a card


@pytest.mark.cuda
def test_a_traced_run_at_the_cells_size(cuda_device):
    """At the cell's own size on the card: correct, one K6 launch a call in
    mode 2 and none in mode 3, the same pieces every call, and each reader
    read."""
    from blinky_tpu_torch.kernels import static_ray

    g0 = static_ray.static_ray_posed.given_launches
    c0 = static_ray.static_ray_posed.cube_launches
    p0 = static_ray.script_pose_plates.pieces
    res, run = _run(True, seed=2**31 + 11, device="cuda:0", seconds=2.0, small=False)
    assert res["correct"] is True, res["checks"]
    calls = run.calls + len(run.state["src"])  # the window's and the warm-up's
    assert static_ray.static_ray_posed.given_launches - g0 == calls
    assert static_ray.static_ray_posed.cube_launches == c0
    m = res["metrics"]
    pieces = static_ray.script_pose_plates.pieces - p0
    assert pieces == calls * m["script_pieces"]["value"]
    for name in ("k6_roofline", "k13_roofline"):
        assert 0 < m[name]["value"] <= 100, (name, m[name])
    assert m["script_plates_ms"]["value"] > 0 and m["rebuilds_in_window"]["value"] == 0
    assert np.isfinite(m["entry_self_ms"]["value"])
