"""The port's regression gate, config suite and entry point
(blinky_tpu_torch/bench/check.py, configs.py, __main__.py) against
blinky_tpu.bench.check and .configs, on the CPU, tolerance 0: the gate's
verdicts on the JAX tests' cases and on random nested results, the suite's
key sets with the measurements stubbed in both packages, the --configs
parser's refusals, and the entry point's refusal to measure without a card."""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from blinky_tpu.bench import check as jcheck
from blinky_tpu.bench import configs as jconfigs
from blinky_tpu.bench import throughput as jt
from blinky_tpu_torch.bench import __main__ as bench_main
from blinky_tpu_torch.bench import check, configs
from blinky_tpu_torch.bench import throughput as tt

REPO = Path(__file__).resolve().parents[1]

BASE = [
    {"config": 4, "name": "batched", "plain_fps": 23000.0,
     "rubix_texels_fps": 33000.0, "build_ms": 100.0, "rubix_rowcrop_fps": None},
    {"config": 0, "name": "roundtrip", "exact": True, "remap_ms": 60.0},
    {"config": 1, "name": "sweep", "stereographic": {"warm_ms": 35.0, "device_ms": 1.9}},
]


def _clone(x=BASE):
    return json.loads(json.dumps(x))


# --------------------------------------------------------------- the verdicts


def _cases():
    """tests/test_bench_check.py's (baseline, current) pairs."""
    out = [(BASE, _clone())]
    cur = _clone()
    cur[0]["plain_fps"], cur[1]["remap_ms"] = 99999.0, 1.0
    out.append((BASE, cur))
    for f in (0.8, 0.9):
        cur = _clone()
        cur[0]["rubix_texels_fps"] = 33000.0 * f
        out.append((BASE, cur))
    for f in (1.5, 3.0):
        cur = _clone()
        cur[1]["remap_ms"] = 60.0 * f
        out.append((BASE, cur))
    cur = _clone()
    cur[2]["stereographic"]["device_ms"], cur[1]["exact"] = 10.0, False
    out.append((BASE, cur))
    cur = _clone()
    del cur[0]["plain_fps"]
    out.append((BASE, cur))
    out.append((BASE, [c for c in _clone() if c["config"] != 0]))
    cur = _clone()
    cur[0]["rubix_rowcrop_fps"] = 5.0
    out.append((BASE, cur))
    base = _clone()
    base[2]["stereographic"]["first_ms"], base[0]["first_build_ms"] = 1500.0, 200.0
    cur = _clone(base)
    cur[2]["stereographic"]["first_ms"], cur[0]["first_build_ms"] = 15000.0, 2000.0
    out.append((base, cur))
    base = _clone()
    base[0]["guarded_fps"] = 100.0
    cur = _clone()
    cur[0]["guarded_fps"], cur[0]["guarded_error"] = None, "OutOfMemoryError"
    out.append((base, cur))
    base = _clone()
    base[0].update(per_frame_fps_scale2=140.0, chunked_fps_1024=22000.0, per_frame_ms=20.0,
                   ms_per_batch=44.0, plain_config="panini 1080p B=4224")
    base[1]["warp_ms_scale2"] = 10.0
    for f in (1.0, 1.2, 1.5):
        cur = _clone(base)
        cur[0]["plain_config"] = "different string"
        cur[0]["per_frame_fps_scale2"] = 140.0 / f
        cur[0]["chunked_fps_1024"] = 22000.0 / f
        cur[0]["per_frame_ms"] = 20.0 * f
        cur[0]["ms_per_batch"] = 44.0 * f
        cur[1]["warp_ms_scale2"] = 10.0 * f * f
        cur[2]["stereographic"]["device_ms"] = 1.9 * f
        out.append((base, cur))
    return out


@pytest.mark.parametrize("case", range(len(_cases())))
def test_compare_results_equals_jax(case):
    base, cur = _cases()[case]
    assert check.compare_results(base, cur) == jcheck.compare_results(base, cur)


def test_the_gate_trips_as_the_jax_tests_say():
    cur = _clone()
    cur[0]["rubix_texels_fps"] = 33000.0 * 0.8
    fails = check.compare_results(BASE, cur)
    assert len(fails) == 1 and "rubix_texels_fps" in fails[0]
    cur = _clone()
    cur[2]["stereographic"]["device_ms"] = 1.9 * 1.5
    assert "device-resident tier" in check.compare_results(BASE, cur)[0]
    assert check.DEVICE_MS_KEYS == jcheck.DEVICE_MS_KEYS
    assert (check.FPS_TOL, check.MS_TOL, check.DEVICE_MS_TOL) == \
        (jcheck.FPS_TOL, jcheck.MS_TOL, jcheck.DEVICE_MS_TOL)


LEAVES = ["plain_fps", "fps", "per_frame_fps_scale2", "chunked_fps_1024", "first_ms",
          "first_build_ms", "warm_ms", "device_ms", "ms_per_batch", "per_frame_ms",
          "per_frame_ms_scale2", "remap_ms", "exact", "coverage", "plates_used", "name",
          "plain_config", "rgba_error", "fpsx", "msec", "ms", "x_ms_y", "fps_"]


def _random_result(rng, cid, depth=0):
    d = {"config": cid, "name": f"c{cid}"} if depth == 0 else {}
    for _ in range(rng.integers(1, 7)):
        key = str(rng.choice(LEAVES))
        r = rng.random()
        if depth < 2 and r < 0.15:
            d[f"sub{rng.integers(3)}"] = _random_result(rng, cid, depth + 1)
        elif key == "exact":
            d[key] = bool(rng.random() < 0.7)
        elif r < 0.25:
            d[key] = None
        else:
            d[key] = float(np.round(rng.uniform(0.1, 100.0), 2))
    return d


def _perturb(rng, d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _perturb(rng, v)
        elif k in ("config", "name") or rng.random() < 0.1:
            out[k] = v if k in ("config", "name") or rng.random() < 0.5 else None
        elif isinstance(v, bool):
            out[k] = v if rng.random() < 0.8 else not v
        elif isinstance(v, float):
            out[k] = float(np.round(v * rng.uniform(0.4, 2.5), 2))
        else:
            out[k] = v
    if rng.random() < 0.2:
        out.pop(next(iter(out)), None)
    return out


@pytest.mark.parametrize("seed", range(40))
def test_compare_results_on_random_nested_results(seed):
    rng = np.random.default_rng(seed)
    base = [_random_result(rng, c) for c in range(rng.integers(1, 5))]
    cur = [_perturb(rng, b) for b in base if rng.random() < 0.9]
    for tol in ((check.FPS_TOL, check.MS_TOL), (0.0, 0.0), (0.5, 2.0)):
        assert (check.compare_results(base, cur, *tol)
                == jcheck.compare_results(base, cur, *tol))
    for key, _ in check._walk({"r": base}):
        assert check._kind(key) == jcheck._kind(key)


@pytest.mark.parametrize("key", LEAVES + [f"a.b.{k}" for k in LEAVES] + ["config", "exact_fps"])
def test_kind_equals_jax(key):
    assert check._kind(key) == jcheck._kind(key)


def test_baseline_roundtrip(tmp_path):
    p = tmp_path / "b.json"
    check.save_baseline(BASE, "full", p, card="NVIDIA H100 80GB HBM3, 700.00 W")
    assert check.load_baseline(p) == ("full", BASE)
    assert json.loads(p.read_text())["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    with pytest.raises(FileNotFoundError, match="check-update"):
        check.load_baseline(tmp_path / "missing.json")


# ---------------------------------------------------------------- run_check


def _gate(monkeypatch, tmp_path, measured, mode="full", write=True):
    """Point the gate at a temporary baseline and a canned run_all."""
    p = tmp_path / "baseline.json"
    if write:
        check.save_baseline(_clone(BASE), mode, p)
    monkeypatch.setattr(check, "BASELINE_PATH", p)
    calls = []

    def fake_run_all(quick=False, only=None, *, device="cuda"):
        calls.append((quick, only, device))
        sel = set(range(8)) if only is None else set(only)
        return [_clone(r) for r in measured if r["config"] in sel]

    monkeypatch.setattr(configs, "run_all", fake_run_all)
    return p, calls


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_check_subset_gates_only_selected_configs(tmp_path, monkeypatch, capsys):
    measured = _clone()
    measured[0]["plain_fps"] = 1.0  # config 4 regressed, but unselected
    _, calls = _gate(monkeypatch, tmp_path, measured)
    assert check.run_check(only=[0, 1], device="cpu") == 0
    assert calls == [(False, [0, 1], "cpu")]
    assert _lines(capsys)[-1]["status"] == "pass"
    assert check.run_check(only=[4], device="cpu") == 1
    out = _lines(capsys)[-1]
    assert out["status"] == "fail" and any("plain_fps" in f for f in out["failures"])


def test_partial_check_update_merges_into_baseline(tmp_path, monkeypatch, capsys):
    measured = _clone()
    measured[0]["plain_fps"] = 50000.0
    measured.append({"config": 7, "name": "brand-new", "new_fps": 1.0})
    p, _ = _gate(monkeypatch, tmp_path, measured)
    assert check.run_check(update=True, only=[4, 7], device="cpu") == 0
    mode, merged = check.load_baseline(p)
    by_id = {r["config"]: r for r in merged}
    assert mode == "full" and by_id[4]["plain_fps"] == 50000.0
    assert by_id[0] == BASE[1] and by_id[1] == BASE[2] and by_id[7]["name"] == "brand-new"
    assert "card" in json.loads(p.read_text())


def test_full_check_update_replaces_wholesale(tmp_path, monkeypatch, capsys):
    measured = [{"config": 0, "name": "only", "fps": 1.0}]
    p, _ = _gate(monkeypatch, tmp_path, measured, write=False)
    assert check.run_check(update=True, device="cpu") == 0
    assert check.load_baseline(p) == ("full", measured)


@pytest.mark.parametrize("update,only", [(False, None), (False, [4]), (True, [4])])
def test_mode_mismatch_refused_before_any_measurement(tmp_path, monkeypatch, capsys,
                                                      update, only):
    """The baseline's mode is checked before run_all, which fails if it is
    called (a wrong-mode run costs no measurement)."""
    _gate(monkeypatch, tmp_path, [], mode="quick")

    def boom(*a, **kw):
        raise AssertionError("run_all ran before the mode check")

    monkeypatch.setattr(configs, "run_all", boom)
    assert check.run_check(update=update, only=only, device="cpu") == 2
    assert _lines(capsys)[-1]["status"] == "mode-mismatch"


@pytest.mark.parametrize("update,only", [(False, None), (True, [4])])
def test_missing_baseline_refused_before_any_measurement(tmp_path, monkeypatch, update, only):
    _gate(monkeypatch, tmp_path, [], write=False)
    monkeypatch.setattr(configs, "run_all", lambda *a, **kw: pytest.fail("run_all ran"))
    with pytest.raises(FileNotFoundError):
        check.run_check(update=update, only=only, device="cpu")


# ------------------------------------------------------------- --configs


def test_parse_configs_arg():
    p = bench_main.parse_configs_arg
    assert p(["x", "--check"]) is None
    assert p(["x", "--check", "--configs", "0,2,5-7"]) == [0, 2, 5, 6, 7]
    assert p(["x", "--configs", "3"]) == [3]
    assert p(["x", "--configs", "0-7"]) == list(range(8))


@pytest.mark.parametrize("spec", [None, "5-3", "3-", "a", "1,,2", "", "-1", "8", "2-9",
                                  "1-2-3", " 1"])
def test_parse_configs_arg_refuses_with_a_usage_line(spec):
    """ADVICE.md's findings: a reversed range selected no config and
    passed, a malformed spec raised a raw ValueError."""
    argv = ["x", "--configs"] + ([] if spec is None else [spec])
    with pytest.raises(SystemExit, match="e.g. 0,2,5-7"):
        bench_main.parse_configs_arg(argv)


def test_run_all_rejects_unknown_config_index():
    with pytest.raises(ValueError, match="unknown config indices"):
        configs.run_all(only=[99], device="cpu")


# ----------------------------------------------------------- config key sets

GENERIC = dict(config="stub", fps=1.0, ms_per_batch=1.0, build_ms=1.0, rebuild_ms=1.0,
               ms_per_chunk=1.0, ms_per_frame=1.0, fps_scale2=1.0, ms_per_frame_scale2=1.0,
               table_ms=1.0, exact_fps=1.0, exact_ms_per_frame=1.0, first_ms=1.0,
               warm_ms=1.0, device_ms=1.0)
RUNS = ("run_throughput", "run_gather_throughput", "run_pose_tracked_throughput",
        "run_per_frame_pose_throughput", "run_static_ray_pose_throughput",
        "run_forward_posed_throughput", "run_build_bench", "run_equirect_throughput")


@pytest.fixture
def stubbed(monkeypatch):
    """Every measurement of both suites stubbed; configs 2 and 3's builds
    return a small table.  Returns the list the port's isolated runs'
    flags land in, and a switch that makes those runs fail."""
    state = {"flags": [], "fail": False, "equal": True}
    for name in RUNS:
        monkeypatch.setattr(jt, name, lambda *a, **kw: dict(GENERIC))
        monkeypatch.setattr(tt, name, lambda *a, **kw: dict(GENERIC, equal=state["equal"]))
    table = types.SimpleNamespace(valid=np.ones((2, 2), bool), plates_used=np.ones(6, bool))
    monkeypatch.setattr(jconfigs, "_timed_build", lambda *a, **kw: (table, 1.0, 1.0))
    monkeypatch.setattr(configs, "_timed_build", lambda *a, **kw: (table, 1.0, 1.0))

    def sub(flag, quick=False):
        state["flags"].append(flag)
        if state["fail"]:
            raise subprocess.CalledProcessError(1, ["python"])
        return {"fps": 1.0, "config": "stub", "ms_per_batch": 1.0}

    monkeypatch.setattr(jconfigs, "_bench_subprocess", sub)
    monkeypatch.setattr(configs, "_bench_subprocess", sub)
    return state


def _keyset(r):
    return {k for k, _ in check._walk(r)}


@pytest.mark.parametrize("cid", range(1, 8))
@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("fail", [False, True])
def test_config_key_sets_equal_jax(stubbed, cid, quick, fail):
    stubbed["fail"] = fail
    ref = jconfigs.run_all(quick=quick, only=[cid])
    port = configs.run_all(quick=quick, only=[cid], device="cpu")
    assert [_keyset(r) for r in port] == [_keyset(r) for r in ref]
    assert port[0]["name"] == ref[0]["name"]
    errors = {k for k in _keyset(port[0]) if k.endswith("_error")}
    assert bool(errors) == (fail and bool(stubbed["flags"]))


@pytest.mark.parametrize("cid,quick", [(1, False), (1, True), (4, False), (4, True),
                                       (5, False), (5, True), (7, True)])
def test_a_kernel_differing_from_its_plain_version_fails_the_config(stubbed, cid, quick):
    """A measurement run in this process whose kernel differs from its
    plain version raises; it is never reported as a number."""
    stubbed["equal"] = False
    with pytest.raises(AssertionError, match="differs from its plain version"):
        configs.run_all(quick=quick, only=[cid], device="cpu")


def test_a_build_differing_from_its_plain_version_fails_configs_2_and_3(monkeypatch):
    """Configs 2 and 3 hold each build's K8 to its plain version first."""
    seen = []

    def differs(*a, **kw):
        seen.append(a[:2])
        return False

    monkeypatch.setattr(tt, "build_equal", differs)
    for fn in (configs.config2_cartographic, configs.config3_low_poly):
        with pytest.raises(AssertionError, match="differs from its plain version"):
            fn(device="cpu")
    assert [(lens.name, g.name) for lens, g in seen] == [("quincuncial", "cube"),
                                                        ("fisheye1", "trism")]


def test_isolated_flags_are_the_jax_suites(stubbed):
    """The suite starts its isolated measurements with the JAX suite's flags."""
    jconfigs.run_all(only=[4, 6, 7])
    ref = list(stubbed["flags"])
    stubbed["flags"].clear()
    configs.run_all(only=[4, 6, 7], device="cpu")
    assert stubbed["flags"] == ref and len(ref) == 6 + 2 + 7


def test_config0_roundtrip_on_the_cpu():
    """Config 0 measures for real: the PCX round trip and an exact remap."""
    port = configs.config0_saveglobe_roundtrip(device="cpu")
    ref = jconfigs.config0_saveglobe_roundtrip()
    assert set(port) == set(ref) and port["exact"] is ref["exact"] is True


def test_isolated_measurement_runs_the_package_from_the_repo(monkeypatch):
    """A measurement process is ``python -m blinky_tpu_torch.bench <flag>``
    from the repository root, started after this process hands its cached
    memory back to the card; a failure is recorded, never a number."""
    calls = []

    def fake_run(args, **kw):
        calls.append((args, kw))
        if "--config4k-rubix" in args:
            raise subprocess.CalledProcessError(1, args, stderr="torch.OutOfMemoryError")
        return subprocess.CompletedProcess(args, 0, 'noise\n{"fps": 12.34, "config": "c"}\n', "")

    released = []
    monkeypatch.setattr(configs.torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(configs.torch.cuda, "empty_cache", lambda: released.append(len(calls)))
    monkeypatch.setattr(configs.subprocess, "run", fake_run)
    out = configs.config6_4k(quick=True, device="cpu")
    # the allocator's cache goes back to the card before each process starts
    assert released == [0, 1]
    assert out["plain_fps"] == 12.3 and out["plain_config"] == "c"
    assert out["rubix_fps"] is None and out["rubix_error"] == "CalledProcessError"
    args, kw = calls[0]
    assert args == [sys.executable, "-m", "blinky_tpu_torch.bench", "--config4k-plain",
                    "--quick"]
    assert kw["cwd"] == configs.ROOT == REPO


# -------------------------------------------------------------- entry point


def test_entry_point_exits_1_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "blinky_tpu_torch.bench"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_launch_counts_name_every_kernel_wrapper(tmp_path, monkeypatch):
    counts = bench_main.launch_counts()
    assert len(counts) == 14 and all(isinstance(n, int) for n in counts.values())
    assert all(counts[name] == fn.launches for name, fn in bench_main.kernel_wrappers().items())
    path = tmp_path / "launches.jsonl"
    monkeypatch.setenv(bench_main.LAUNCHES_ENV, str(path))
    bench_main._record_launches(["x", "--all"])
    bench_main._record_launches(["x", "--sol"])
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [line["argv"] for line in lines] == [["--all"], ["--sol"]]
    assert lines[0]["launches"] == counts


_NO_JAX = """
import sys
import blinky_tpu_torch.bench.__main__, blinky_tpu_torch.bench.autobatch
import blinky_tpu_torch.bench.calibrate, blinky_tpu_torch.bench.check
import blinky_tpu_torch.bench.configs, blinky_tpu_torch.bench.throughput
import blinky_tpu_torch.budget
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "blinky_tpu" or m.startswith("blinky_tpu."))
print(bad)
"""


def test_the_bench_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    for p in (REPO / "blinky_tpu_torch" / "bench").glob("*.py"):
        text = p.read_text()
        assert "import jax" not in text and "from blinky_tpu." not in text, p


def test_committed_baseline_loads():
    """The port ships an H100 baseline in full mode, every config's gated
    keys measured, the card named beside it."""
    mode, results = check.load_baseline()
    assert mode == "full" and sorted(r["config"] for r in results) == list(range(8))
    assert json.loads(check.BASELINE_PATH.read_text())["card"].startswith("NVIDIA H100")
    for r in results:
        leaves = dict(check._walk(r))
        assert not [k for k in leaves if k.endswith("_error")], r
        assert all(v is not None for k, v in leaves.items() if check._kind(k)), r
        assert all(v for k, v in leaves.items() if check._kind(k) == "bool"), r
