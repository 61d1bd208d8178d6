"""BENCHMARK.json against the contract, every name resolved to its files,
the seeded inputs, the trace's reduction to metrics, and every cell
rehearsed on the CPU at a tiny size."""

import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, rooflines, sources, trace
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["paths"] == ["benchmark"]
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\n" not in w for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    spec = SPEC
    names = [e["name"] for e in spec[kind]]
    assert len(names) == len(set(names))
    for e in spec[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_configs_resolve_and_are_each_used():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/")
        body = harness.load_json(harness.REPO / c["file"])
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_config_mix_driver_and_metrics(cell):
    spec = SPEC
    w, cfg, mix = harness.resolve(spec, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and NAME.match(w["traffic"])
    driver = harness.load_module("drivers", mix["driver"])
    for hook in ("setup", "step", "drain", "check"):
        assert callable(getattr(driver, hook))
    for trace_on in (False, True):
        for m in harness.metrics_for(spec, w, trace_on):
            assert callable(harness.load_module("metrics", m["name"]).read)
    e2e = [m["name"] for m in harness.metrics_for(spec, w, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(spec, w, True)
    assert mix["limits"]


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    spec = SPEC
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert "bound" not in m and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")


def test_per_layer_metrics_move_a_metric_their_cells_report():
    spec = SPEC
    for m in spec["per_layer"]:
        assert m["moves"] != "setup_s"
        for cell in m["workloads"]:
            w = next(x for x in spec["workloads"] if x["name"] == cell)
            assert m["moves"] in [e["name"] for e in harness.metrics_for(spec, w, False)]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in spec["per_layer"]}
    assert all(x == x.strip() and "\n" not in x for x in layers)


# ------------------------------------------------------------------ inputs


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33 + 5])
def test_sources_are_a_function_of_the_seed(seed):
    a = sources.cubemap_batches(8, 3, 2, seed, "cpu")
    b = sources.cubemap_batches(8, 3, 2, seed, "cpu")
    c = sources.cubemap_batches(8, 3, 2, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    p = sources.pano_batches(4, 8, 3, 1, seed, "cpu")[0]
    assert p.shape == (4, 8, 3) and p.dtype == torch.uint32
    assert torch.equal(p.view(torch.int32), sources.pano_batches(4, 8, 3, 1, seed, "cpu")[0]
                       .view(torch.int32))


def test_reservoir_is_seeded_bounded_and_reaches_the_whole_window():
    kept = []
    for seed in (99, 99, 100):
        r = sources.Reservoir(4, seed)
        for i in range(1000):
            r.offer(i)
        kept.append(sorted(r.items.values()))
    assert kept[0] == kept[1] != kept[2]
    assert len(kept[0]) == 4 and max(kept[0]) >= 4
    r = sources.Reservoir(4, 1)
    for i in range(3):
        r.offer(i)
    assert sorted(r.items.values()) == [0, 1, 2]


# ------------------------------------------------------------------- trace


def _chrome(events):
    return [dict(ph="X", **e) for e in events]


def test_trace_reduction_and_the_readers():
    ev = _chrome([
        dict(name=trace.WINDOW, cat="user_annotation", ts=1000, dur=1000),
        dict(name="bench.render", cat="user_annotation", ts=1000, dur=400),
        dict(name="void remap_gather_kernel<unsigned char>(x)", cat="kernel", ts=900, dur=300),
        dict(name="void remap_gather_kernel<unsigned char>(x)", cat="kernel", ts=1300, dur=250),
        dict(name="Memcpy DtoD (Device -> Device)", cat="gpu_memcpy", ts=1600, dur=100,
             args={"bytes": 5_000_000}),
        dict(name="lensmap_resolve_kernel", cat="kernel", ts=1650, dur=100),
        dict(name="cudaLaunchKernel", cat="cuda_runtime", ts=1000, dur=5),
    ])
    t = trace.from_events(ev)
    assert t.window == (1000e-6, 2000e-6)
    assert len(t.device) == 4  # the first kernel clipped to the window, the runtime call out
    assert t.busy_s() == pytest.approx(200e-6 + 250e-6 + 150e-6)
    assert sum(b - a for a, b in t.idle_gaps()) == pytest.approx(t.window_s - t.busy_s())
    bd = t.breakdown()
    assert bd["device_ops"][0][0].startswith("void remap_gather_kernel")
    assert {n for n, _ in bd["idle_gaps"]} == {"bench.render", "outside any span"}

    class R:
        pass

    run = R()
    run.trace, run.facts = t, {"k1_bytes": 3.35e12 * 100e-6}
    k1 = harness.load_module("metrics", "k1_roofline").read(run)
    assert k1 == pytest.approx(100.0 * 100e-6 / 250e-6)  # the cut record is left out
    idle = harness.load_module("metrics", "device_idle_pct.throughput").read(run)
    assert idle == pytest.approx(100 * (1 - 600 / 1000))
    run.trace = None
    assert harness.load_module("metrics", "k1_roofline").read(run) is None


def test_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        trace.from_events(_chrome([dict(name="k", cat="kernel", ts=0, dur=1)]))


def test_roofline_share_counts_what_the_inputs_need():
    assert rooflines.gather_bytes(10, 4, 2, 1) == 4 * 6 + 14 * 2
    assert rooflines.equirect_gather_bytes(5, 3, 2) == 8 * 2 * 4 + 3 * 36
    assert rooflines.share_of_bound(1.0, 0, 1.0) is None


def test_share_of_op_bound_is_counted_as_k6s_bound():
    # K6 at 1080p, B = 64: 86 FP32 operations a pose and pixel, a bound of
    # 0.3407 ms; 0.8283 ms a call is 41.1 % of it
    ops = 86 * 64 * 1920 * 1080
    assert ops == 11_413_094_400
    assert ops / rooflines.FP32_OPS_PER_S == pytest.approx(0.3407e-3, abs=5e-8)
    assert rooflines.share_of_op_bound(ops, 2, 2 * 0.8283e-3) == pytest.approx(41.13, abs=0.01)
    assert rooflines.share_of_op_bound(ops, 0, 1.0) is None
    assert rooflines.share_of_op_bound(ops, 3, 0.0) is None


# --------------------------------------------------------------- rehearsal


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_the_cpu_at_a_tiny_size(cell, traced):
    res, run = harness.run_cell(SPEC, cell, 2**31 + 7, 0.4, traced, device="cpu",
                                t_start=time.perf_counter(), cfg_override=SMALL_CFG,
                                mix_override={**SMALL_MIX, "trace_seconds": 0.1})
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] == run.calls > 0
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    if traced:
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        w = next(x for x in SPEC["workloads"] if x["name"] == cell)
        assert set(res["metrics"]) == {m["name"] for m in harness.metrics_for(SPEC, w, False)}
        assert all(v["value"] > 0 for v in res["metrics"].values())


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=harness.REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cuda_device, cell):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                        "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
                       cwd=harness.REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    import json

    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
