"""The readers of the program's spans (``entry_self_ms``, ``launch_wait_ms``,
``rebuilds_in_window``) on synthetic Chrome traces, and every cell they
list traced on the CPU with them."""

import time

import pytest

from benchmark import harness, trace
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
READERS = ("entry_self_ms", "launch_wait_ms", "rebuilds_in_window")
LISTED = {m["name"]: m["workloads"] for m in SPEC["per_layer"] if m["name"] in READERS}
SPAN_CELLS = [c for c in CELLS if any(c in cells for cells in LISTED.values())]


def _span(name, ts, dur):
    return dict(ph="X", name=name, cat="user_annotation", ts=ts, dur=dur)


class _Run:
    def __init__(self, events):
        self.trace = trace.from_events(events)
        self.facts = {}


def _read(name, events):
    return harness.load_module("metrics", name).read(_Run(events))


WINDOW = _span(trace.WINDOW, 1000, 1000)  # microseconds 1000-2000


def _calls():
    """Three calls wholly inside the window, one cut by each edge."""
    return [
        WINDOW,
        # cut by the window's start: left out
        _span("bench.render", 950, 100), _span("session.render", 955, 90),
        _span("launch.remap_gather", 960, 80),
        # call 1: 100 us, launches 10 + 60 us
        _span("bench.render", 1100, 105), _span("session.render", 1100, 100),
        _span("launch.remap_gather", 1110, 10), _span("launch.remap_lut", 1130, 60),
        # call 2: 200 us, a rebuild (a lensmap inside a kernel object) and
        # two launches that overlap: 40 us of union, 50 us summed
        _span("session.render_equirect", 1300, 200),
        _span("build.remap_kernel", 1310, 50), _span("build.lensmap", 1315, 30),
        _span("launch.equirect_gather", 1400, 30), _span("launch.remap_gather", 1420, 20),
        # call 3: 50 us, no launch, a nested entry (faces through render)
        _span("session.render_equirect", 1600, 50), _span("session.render", 1610, 30),
        # cut by the window's end: left out, its build starts inside
        _span("session.render", 1950, 100), _span("build.ingest", 1960, 80),
        _span("launch.remap_gather", 1990, 20),
    ]


def test_entry_self_ms_is_the_median_call_less_its_launches():
    # calls: 100 - 70, 200 - 40 (the union), 50 - 0 -> median 50 us
    assert _read("entry_self_ms", _calls()) == pytest.approx(0.050)


def test_launch_wait_ms_is_the_median_summed_launches():
    # calls: 70, 50 (summed), 0 -> median 50 us
    assert _read("launch_wait_ms", _calls()) == pytest.approx(0.050)


def test_rebuilds_in_window_counts_every_build_that_starts_in_it():
    # two in call 2 (nested, each counted), one in the call cut by the end
    assert _read("rebuilds_in_window", _calls()) == 3
    steady = [e for e in _calls() if not e["name"].startswith("build.")]
    assert _read("rebuilds_in_window", steady) == 0


def test_one_call_wholly_inside():
    ev = [WINDOW, _span("session.render", 1200, 400), _span("launch.remap_gather", 1250, 300)]
    assert _read("entry_self_ms", ev) == pytest.approx(0.100)
    assert _read("launch_wait_ms", ev) == pytest.approx(0.300)
    assert _read("rebuilds_in_window", ev) == 0


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_programs_spans(name):
    """A program without spans (the benchmark's own span alone), or no
    trace: no value, and no error."""
    ev = [WINDOW, _span("bench.render", 1100, 100),
          dict(ph="X", name="remap_gather_kernel", cat="kernel", ts=1100, dur=90)]
    assert _read(name, ev) is None
    run = _Run(ev)
    run.trace = None
    assert harness.load_module("metrics", name).read(run) is None


def test_launch_wait_reads_nothing_without_launches():
    """The CPU: calls and no launch."""
    ev = [WINDOW, _span("session.render", 1200, 400), _span("session.render", 1700, 100)]
    assert _read("launch_wait_ms", ev) is None
    assert _read("entry_self_ms", ev) == pytest.approx(0.250)


@pytest.mark.parametrize("name", READERS)
def test_spans_readers_are_listed_for_both_cells(name):
    """The first two cells by name, so that neither drops out unseen; a
    later cell may be listed too, if the spec has it."""
    m = next(x for x in SPEC["per_layer"] if x["name"] == name)
    assert m["source"] == "program_span" and m["moves"] == "screens_per_s"
    assert {"pc1080.batch_card", "v360.compact_card"} <= set(m["workloads"])
    assert set(m["workloads"]) <= set(CELLS) and len(set(m["workloads"])) == len(m["workloads"])
    assert m["layer"] == ("build" if name == "rebuilds_in_window" else "entry")


@pytest.mark.parametrize("cell", SPAN_CELLS)
def test_traced_cpu_run_reads_the_program_spans(cell):
    """Each reader that lists *cell* reads it; the entry span is the one its
    driver declares."""
    res, run = harness.run_cell(SPEC, cell, 2**31 + 19, 0.4, True, device="cpu",
                                t_start=time.perf_counter(), cfg_override=SMALL_CFG,
                                mix_override={**SMALL_MIX, "trace_seconds": 0.1})
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    if cell in LISTED["rebuilds_in_window"]:
        assert m["rebuilds_in_window"]["value"] == 0  # every rebuild was in the set-up
    if cell in LISTED["entry_self_ms"]:
        assert m["entry_self_ms"]["value"] > 0 and m["entry_self_ms"]["unit"] == "ms"
    assert "launch_wait_ms" not in m  # no launch on the CPU
    driver = harness.load_module("drivers", run.mix["driver"])
    names = {s.name for s in run.trace.spans}
    assert {"bench.render", driver.ENTRY_SPAN} <= names, names
