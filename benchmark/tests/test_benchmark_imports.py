"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``blinky_tpu_torch`` is not ``blinky_tpu``),
and the reference imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "blinky_tpu"}
HARNESS_FILES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts)


def _imports(path: Path) -> set:
    """Top-level names of every import in *path* (relative ones as ``.``),
    function-level ones included."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    assert "blinky_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "blinky_tpu.api".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", HARNESS_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_harness_sources_import_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {".", "__future__", "importlib", "math", "dataclasses", "numpy",
                              "torch"}


def test_only_program_py_imports_the_program():
    users = {p.relative_to(ROOT).as_posix() for p in HARNESS_FILES
             if "blinky_tpu_torch" in _imports(p)}
    assert users == {"program.py"}


RUN_ALL = """
import json, sys, time
sys.path.insert(0, {repo!r})
from benchmark import harness
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX
spec = harness.benchmark_spec()
for w in spec["workloads"]:
    harness.run_cell(spec, w["name"], 5, 0.2, False, device="cpu", t_start=time.perf_counter(),
                     cfg_override=SMALL_CFG, mix_override=SMALL_MIX)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_of_every_cell_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", RUN_ALL.format(repo=str(harness.REPO))],
                       capture_output=True, text=True, timeout=600, cwd=harness.REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "blinky_tpu_torch" in loaded and not (loaded & FORBIDDEN)


FAKE_JAX = """
import sys, time, types
sys.path.insert(0, {repo!r})
from benchmark import compare, harness
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX


def plant():
    sys.modules[{module!r}] = types.ModuleType({module!r})


if {when!r} == "before":
    plant()
else:  # while the check compares the window's outputs with the reference
    worst = compare.worst_lane_mismatch
    compare.worst_lane_mismatch = lambda *a: (plant(), worst(*a))[1]
spec = harness.benchmark_spec()
try:
    harness.run_cell(spec, "pc1080.batch_card", 5, 0.1, False, device="cpu",
                     t_start=time.perf_counter(), cfg_override=SMALL_CFG,
                     mix_override=SMALL_MIX)
except ImportError as e:
    print("refused:", e)
else:
    print("a result")
"""


@pytest.mark.parametrize("when", ["before", "during_check"])
@pytest.mark.parametrize("module", ["jax", "blinky_tpu.api"])
def test_a_run_that_loaded_jax_is_refused(when, module):
    p = subprocess.run([sys.executable, "-c",
                        FAKE_JAX.format(repo=str(harness.REPO), module=module, when=when)],
                       capture_output=True, text=True, timeout=300, cwd=harness.REPO)
    top = module.split(".")[0]
    assert f"refused: the run loaded {top}" in p.stdout, (p.stdout[-500:], p.stderr[-2000:])


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    import shutil

    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "pc1080.batch_card",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
