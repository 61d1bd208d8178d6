"""The port's batch planner and calibrate walk
(blinky_tpu_torch/budget.py, bench/autobatch.py, calibrate.py) against
blinky_tpu.bench.autobatch and .calibrate, on the CPU, tolerance 0."""

import json
import subprocess

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from blinky_tpu.bench import autobatch as jab
from blinky_tpu_torch import budget as bud
from blinky_tpu_torch.bench import autobatch as ab
from blinky_tpu_torch.bench import calibrate

# panini@180 1080p compaction stats of the exact host lensmap
TEXELS = 1_696_377
ROWS, ROWS_RUBIX = 3663, 7132
# the JAX planner's v5e budget, handed to the port as budget=
V5E_BUDGET = int(jab.V5E_HBM_BYTES * jab.EFFECTIVE_FRACTION)


@pytest.mark.parametrize("rgba", [False, True])
@pytest.mark.parametrize("expanded", [False, True])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("planesize,nplanes", [(48, 2), (48, 6), (1080, 5), (2160, 12)])
def test_planes_bytes_per_lane_equals_jax(planesize, nplanes, rgba, expanded, padded):
    assert (bud.planes_bytes_per_lane(planesize, nplanes, rgba, expanded, padded)
            == jab.planes_bytes_per_lane(planesize, nplanes, rgba, expanded, padded))


@pytest.mark.parametrize("rgba", [False, True])
def test_rows_texels_screen_models_equal_jax(rgba):
    for n in (1, ROWS, ROWS_RUBIX):
        for s in (48, 1080, 2160):
            assert ab.rows_bytes_per_lane(n, s, rgba) == jab.rows_bytes_per_lane(n, s, rgba)
    for n in (1, TEXELS):
        assert ab.texels_bytes_per_lane(n, rgba) == jab.texels_bytes_per_lane(n, rgba)
    for w, h in ((64, 48), (1920, 1080), (3840, 2160)):
        assert bud.screen_bytes_per_lane(w, h, rgba) == jab.screen_bytes_per_lane(w, h, rgba)


@settings(max_examples=400, deadline=None)
@given(src=st.integers(0, 10**11), out=st.integers(0, 10**9),
       budget=st.integers(0, 10**12), quantum=st.sampled_from([1, 2, 16, 128, 1000]),
       cap=st.one_of(st.none(), st.integers(0, 10**6)), n_devices=st.integers(0, 9))
def test_feasible_batch_equals_jax(src, out, budget, quantum, cap, n_devices):
    assert (bud.feasible_batch(src, out, budget=budget, quantum=quantum, cap=cap,
                              n_devices=n_devices)
            == jab.feasible_batch(src, out, budget=budget, quantum=quantum, cap=cap,
                                  n_devices=n_devices))


@pytest.mark.parametrize("src,out,expect", [
    (ab.texels_bytes_per_lane(TEXELS), bud.screen_bytes_per_lane(1920, 1080), 4224),
    (ab.texels_bytes_per_lane(TEXELS, rgba=True),
     bud.screen_bytes_per_lane(1920, 1080, rgba=True), 1024),
    (ab.rows_bytes_per_lane(ROWS, 1080), bud.screen_bytes_per_lane(1920, 1080), 2560),
    (ab.rows_bytes_per_lane(ROWS_RUBIX, 1080), bud.screen_bytes_per_lane(1920, 1080), 1536),
    (ab.rows_bytes_per_lane(ROWS, 1080, rgba=True),
     bud.screen_bytes_per_lane(1920, 1080, rgba=True), 640),
    (bud.planes_bytes_per_lane(1080, 5, padded=False), bud.screen_bytes_per_lane(1920, 1080),
     2048),
    (bud.planes_bytes_per_lane(2160, 5, padded=False), bud.screen_bytes_per_lane(3840, 2160),
     512),
    (bud.planes_bytes_per_lane(2160, 5, expanded=True, padded=False),
     bud.screen_bytes_per_lane(3840, 2160), 256),
])
def test_v5e_budget_reproduces_the_jax_calibration_table(src, out, expect):
    """tests/test_autobatch.py's table, from the JAX budget handed over."""
    assert bud.feasible_batch(src, out, budget=V5E_BUDGET, quantum=ab.QUANTUM) == expect


def test_the_session_default_does_not_round():
    """Session callers keep quantum 1 and the free-memory budget: the
    posed path's, the sweep's and the script resolver's chunks."""
    assert bud.feasible_batch(1, 0, budget=1000) == 1000
    assert bud.feasible_batch(1, 0, budget=1000, quantum=ab.QUANTUM) == 896
    assert bud.feasible_batch(10**15, 0, budget=V5E_BUDGET, quantum=ab.QUANTUM) == 1
    assert bud.feasible_batch(260_000_000, 0, budget=V5E_BUDGET, quantum=ab.QUANTUM) == 62
    assert bud.feasible_batch(1, 0, device="cpu", cap=37) == 37


def test_two_budgets(monkeypatch):
    """The bench budget is the whole memory times EFFECTIVE_FRACTION; the
    Session budget the free memory times BUDGET_FRACTION."""
    monkeypatch.setenv("BLINKY_HBM_BYTES", "80000000000")
    assert ab.device_hbm_bytes("cpu") == 80_000_000_000
    assert ab.effective_budget_bytes("cpu") == int(80e9 * ab.EFFECTIVE_FRACTION)
    assert 0 < ab.EFFECTIVE_FRACTION < 1
    monkeypatch.setattr(bud, "device_memory_bytes", lambda d: 10**9)
    assert bud.free_budget_bytes("cpu") == int(1e9 * bud.BUDGET_FRACTION)
    assert bud.feasible_batch(10**6, 0, device="cpu") == int(1e9 * bud.BUDGET_FRACTION) // 10**6
    monkeypatch.delenv("BLINKY_HBM_BYTES")
    with pytest.raises(ValueError, match="BLINKY_HBM_BYTES"):
        ab.device_hbm_bytes("cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        ab.effective_budget_bytes("cpu")


# ------------------------------------------------------------ calibrate walk

PER_LANE = 3.77e6
HBM = 80_000_000_000


@pytest.fixture
def walk(tmp_path, monkeypatch):
    monkeypatch.setenv("BLINKY_HBM_BYTES", str(HBM))
    monkeypatch.setattr(calibrate, "probe_layout_bytes", lambda: PER_LANE)
    monkeypatch.setattr(calibrate, "CALIBRATION_PATH", tmp_path / "cal.json")
    return tmp_path / "cal.json"


def _last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_calibrate_finds_oom_boundary(walk, capsys):
    """The walk climbs QUANTUM steps from the derived batch to the first
    (simulated) OOM and reports an interval around the true capacity."""
    c_true = ab.effective_budget_bytes("cpu") + 2 * 128 * PER_LANE + 1
    assert calibrate.run_calibrate(probe=lambda b: b * PER_LANE <= c_true, device="cpu") == 0
    out = _last(capsys)
    assert out["status"] == "ok"
    assert out["C_ok"] <= c_true < out["C_fail"]
    assert out["first_fail_batch"] == out["last_ok_batch"] + ab.QUANTUM
    assert json.loads(walk.read_text())["C_ok"] == out["C_ok"]
    assert out["implied_fraction_lo"] < out["implied_fraction_hi"]
    assert out["committed_fraction"] == ab.EFFECTIVE_FRACTION
    assert "committed_inside_interval" in out and "card" in out


def test_calibrate_reaches_the_whole_memory(walk, capsys):
    """By default the walk has the steps to pass the card's whole memory
    from the derived batch: a card that only runs out at its last byte is
    still found."""
    probes = []

    def probe(b):
        probes.append(b)
        return b * PER_LANE <= HBM

    assert calibrate.run_calibrate(probe=probe, device="cpu") == 0
    out = _last(capsys)
    assert out["last_ok_batch"] * PER_LANE <= HBM < out["first_fail_batch"] * PER_LANE
    assert probes[0] == bud.feasible_batch(PER_LANE, 0, budget=ab.effective_budget_bytes("cpu"),
                                          quantum=ab.QUANTUM)


def test_calibrate_derived_batch_must_run(walk, capsys):
    assert calibrate.run_calibrate(probe=lambda b: False, device="cpu") == 1
    assert _last(capsys)["status"] == "error"
    assert not walk.exists()


def test_calibrate_non_oom_failure_aborts(walk, capsys):
    calls = []

    def probe(b):
        calls.append(b)
        if len(calls) == 1:
            return True
        raise calibrate.CalibrationProbeError(f"probe B={b} timed out after 900s")

    assert calibrate.run_calibrate(probe=probe, device="cpu") == 1
    out = _last(capsys)
    assert out["status"] == "error" and "timed out" in out["detail"]
    assert not walk.exists()


def test_calibrate_no_oom_found_keeps_the_committed_file(walk, capsys):
    committed = '{"status": "ok", "C_ok": 123}\n'
    walk.write_text(committed)
    assert calibrate.run_calibrate(probe=lambda b: True, max_steps=3, device="cpu") == 1
    out = _last(capsys)
    assert out["status"] == "no-oom-found" and out["first_fail_batch"] is None
    assert "nothing written" in out["detail"]
    assert walk.read_text() == committed


def test_calibrate_walks_like_jax(walk, monkeypatch, capsys):
    """Given the JAX planner's budget, steps and probe, the port's walk
    reports the JAX walk's batches and budgets."""
    from blinky_tpu.bench import calibrate as jcal

    monkeypatch.setattr(jcal, "probe_layout_bytes", lambda: PER_LANE)
    monkeypatch.setattr(jcal, "CALIBRATION_PATH", walk.parent / "jax.json")
    monkeypatch.setenv("BLINKY_HBM_BYTES", str(jab.V5E_HBM_BYTES))
    monkeypatch.setattr(ab, "EFFECTIVE_FRACTION", jab.EFFECTIVE_FRACTION)
    c_true = jab.effective_budget_bytes() + 3 * 128 * PER_LANE + 1
    probe = lambda b: b * PER_LANE <= c_true  # noqa: E731
    assert jcal.run_calibrate(probe=probe, max_steps=12) == 0
    ref = _last(capsys)
    assert calibrate.run_calibrate(probe=probe, max_steps=12, device="cpu") == 0
    got = _last(capsys)
    for key in ("status", "per_lane_bytes", "last_ok_batch", "first_fail_batch", "C_ok",
                "C_fail", "implied_fraction_lo", "implied_fraction_hi",
                "committed_inside_interval", "committed_vs_measured_pct"):
        assert got[key] == ref[key], key


@pytest.mark.parametrize("mode", ["ok", "oom", "other-oom-text", "crash", "timeout"])
def test_spawn_probe_classifies_failures(monkeypatch, mode):
    """Exit 0 -> True; a death with torch's OOM message -> False; the JAX
    package's XLA marker, any other death and a timeout -> an error."""
    calls = []

    def fake_run(args, **kw):
        calls.append((args, kw))
        if mode == "ok":
            return subprocess.CompletedProcess(args, 0, '{"ok": true}', "")
        if mode == "timeout":
            raise subprocess.TimeoutExpired(args, 900)
        err = {"oom": "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 45.00 GiB",
               "other-oom-text": "RESOURCE_EXHAUSTED: Out of memory allocating",
               "crash": "ModuleNotFoundError: no spam"}[mode]
        raise subprocess.CalledProcessError(1, args, output="", stderr=err)

    monkeypatch.setattr(calibrate.subprocess, "run", fake_run)
    if mode == "ok":
        assert calibrate._spawn_probe(128, 900.0) is True
    elif mode == "oom":
        assert calibrate._spawn_probe(128, 900.0) is False
    else:
        with pytest.raises(calibrate.CalibrationProbeError,
                           match="timed out" if mode == "timeout" else "OOM marker"):
            calibrate._spawn_probe(128, 900.0)
    args, kw = calls[0]
    assert args[1:] == ["-m", "blinky_tpu_torch.bench", "--calibrate-probe", "128"]
    assert kw["cwd"] == calibrate.ROOT


def test_probe_layout_bytes_is_the_headline_lane():
    """3,769,977 bytes: the exact lensmap's 1,696,377 texels and a 1080p
    screen, the JAX probe's own count."""
    from blinky_tpu.bench import calibrate as jcal

    assert calibrate.probe_layout_bytes() == jcal.probe_layout_bytes() == TEXELS + 1920 * 1080


def test_result_files_live_in_the_port():
    """The H100 baseline and calibration are the port's own files, never
    the JAX package's root JSON files."""
    from pathlib import Path

    from blinky_tpu_torch.bench import check

    pkg = Path(ab.__file__).resolve().parent
    assert calibrate.CALIBRATION_PATH.parent == pkg
    assert check.BASELINE_PATH.parent == pkg
    root = pkg.parents[1]
    assert calibrate.CALIBRATION_PATH != root / "bench_calibration.json"
    assert check.BASELINE_PATH != root / "bench_baseline.json"


def test_committed_calibration_bounds_the_constant():
    """The committed walk was measured on an H100 with its card named, and
    EFFECTIVE_FRACTION sits under its implied_fraction_lo, so the planner
    never derives a batch past the measured boundary."""
    cal = json.loads(calibrate.CALIBRATION_PATH.read_text())
    assert cal["status"] == "ok" and cal["card"].startswith("NVIDIA H100")
    assert cal["committed_fraction"] == ab.EFFECTIVE_FRACTION < cal["implied_fraction_lo"]
    assert cal["C_ok"] == cal["per_lane_bytes"] * cal["last_ok_batch"]
    assert cal["first_fail_batch"] == cal["last_ok_batch"] + ab.QUANTUM
    derived = bud.feasible_batch(cal["per_lane_bytes"], 0,
                                budget=int(cal["hbm_bytes"] * ab.EFFECTIVE_FRACTION),
                                quantum=ab.QUANTUM)
    assert derived < cal["first_fail_batch"] and derived <= cal["last_ok_batch"]
