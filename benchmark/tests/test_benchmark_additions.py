"""A cell joins the benchmark by new files alone: a configuration file, a
traffic mix file, its entries in ``BENCHMARK.json`` and its name appended
to the metrics it reports."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

from benchmark import harness

PROBE_CONFIG = "probe_cube_1080p_u8"
PROBE_MIX = "probe_batch_b64"
PROBE_CELL = "probe.render_b64"  # a name that tells nothing of its driver
# existing metrics that a cell of the batch driver reports, each of which
# the probe is appended to (a cell reports one per-layer metric at least);
# not every span reader, which a cell need not join
PROBE_METRICS = ("screens_per_s", "k1_roofline", "device_idle_pct.throughput",
                 "entry_self_ms", "rebuilds_in_window")
# the cell-parametrised tests that a CPU run collects for such a cell
PROBE_CASES = {
    "test_cell_resolves_to_its_config_mix_driver_and_metrics",
    "test_cell_runs_on_the_cpu_at_a_tiny_size",  # untraced and traced
    "test_the_control_fails_the_limit",
    "test_the_program_passes",
    "test_traced_cpu_run_reads_the_program_spans",
}
SPEC_TESTS = ("test_top_level_keys_and_paths", "test_run_seconds_fit_a_full_check_of_24_cells",
              "test_names_and_units", "test_configs_resolve_and_are_each_used",
              "test_pairs_of_config_and_traffic_appear_once", "test_bounds_and_sources",
              "test_per_layer_metrics_move_a_metric_their_cells_report",
              "test_spans_readers_are_listed_for_both_cells")


# ----------------------------------------------------------- the probe cell


def _digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _checkout_with_probe(root: Path, listed: bool) -> None:
    """A copy of the benchmark with a probe cell added by new files and
    entries: Blinky's default configuration under another name, batch 64
    through the batch driver.  Unless *listed*, the probe is left out of
    ``screens_per_s``'s list."""
    shutil.copy(harness.REPO / "BENCHMARK.json", root)
    shutil.copytree(harness.ROOT, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "benchmark")
    base = harness.load_json(root / "benchmark/configs/panini_cube_1080p_u8.json")
    cfg = {**base, "name": PROBE_CONFIG}
    cfg_file = f"benchmark/configs/{PROBE_CONFIG}.json"
    (root / cfg_file).write_text(json.dumps(cfg, indent=2))
    mix = {"driver": "batch_card", "batch": 64, "ring": 2, "trace_seconds": 3,
           "check_sample": 3, "limits": {"screen_mismatch": 0.0025}}
    (root / f"benchmark/traffic/{PROBE_MIX}.json").write_text(json.dumps(mix, indent=2))
    spec = harness.load_json(root / "BENCHMARK.json")
    spec["configs"].append({"name": PROBE_CONFIG, "source": base["source"], "file": cfg_file,
                            "reduced": [], "why": "a probe: Blinky's defaults under a new name"})
    spec["workloads"].append({"name": PROBE_CELL, "config": PROBE_CONFIG, "traffic": PROBE_MIX,
                              "chips": 1, "why": "a probe: Session.render of B=64 on the card"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in PROBE_METRICS and (listed or m["name"] != "screens_per_s"):
            m["workloads"].append(PROBE_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before  # no file of the benchmark edited
    assert set(after) - set(before) == {f"configs/{PROBE_CONFIG}.json", f"traffic/{PROBE_MIX}.json"}


def _pytest(root: Path, select: str) -> tuple:
    """Run the copy's CPU tests that *select* picks, from the copy's root,
    with the program importable: (return code, {test id: outcome}, the end
    of the output)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        filter(None, [str(harness.REPO), os.environ.get("PYTHONPATH")]))}
    xml = root / "probe.xml"
    p = subprocess.run([sys.executable, "-m", "pytest", "benchmark/tests", "-q",
                        "-p", "no:cacheprovider", "-p", "no:xdist", "-m", "not cuda",
                        "--ignore", "benchmark/tests/test_benchmark_additions.py",
                        "-k", select, f"--junitxml={xml}"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=900)
    outcomes = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        bad = [c.tag for c in case if c.tag in ("failure", "error", "skipped")]
        outcomes[case.get("name")] = bad[0] if bad else "passed"
    return p.returncode, outcomes, p.stdout[-3000:]


def test_a_cell_added_by_new_files_alone_rehearses(tmp_path):
    _checkout_with_probe(tmp_path, listed=True)
    rc, outcomes, out = _pytest(tmp_path, " or ".join(
        [PROBE_CELL, "test_a_run_of_every_cell_loads_no_jax", *SPEC_TESTS]))
    assert rc == 0, out
    assert all(v == "passed" for v in outcomes.values()), out
    probe = [name for name in outcomes if PROBE_CELL in name]
    assert {name.split("[")[0] for name in probe} == PROBE_CASES, sorted(outcomes)
    assert len(probe) == len(PROBE_CASES) + 1  # the rehearsal, traced and untraced
    assert {"test_a_run_of_every_cell_loads_no_jax", *SPEC_TESTS} <= {
        name.split("[")[0] for name in outcomes}


def test_a_probe_left_out_of_its_metric_fails(tmp_path):
    _checkout_with_probe(tmp_path, listed=False)
    rc, outcomes, out = _pytest(
        tmp_path, f"test_cell_resolves_to_its_config_mix_driver_and_metrics and {PROBE_CELL}")
    assert rc != 0
    assert outcomes == {
        f"test_cell_resolves_to_its_config_mix_driver_and_metrics[{PROBE_CELL}]": "failure"}, out
