"""``k14_roofline``, K14's share of its byte bound in ``lfast.posed_card``,
on synthetic traces: what it reads, its byte count against PERF.md's
kernel table, and nothing from a program that evaluates the script
without K14 (the parent's, whose window holds the evaluator's library
kernels)."""

import pytest

from benchmark import harness, k14_bytes, rooflines, trace

SPEC = harness.benchmark_spec()
CELL = "lfast.posed_card"
K13 = "void (anonymous namespace)::rotate_rays_kernel<true, 4>(x)"
K14 = "void (anonymous namespace)::script_tape_kernel(x)"
LIB = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_div(x)>"


def _span(name, ts, dur, cat="user_annotation"):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


class _Run:
    def __init__(self, events, cfg, mix, facts):
        self.trace = trace.from_events(events)
        self.cfg, self.mix, self.facts = cfg, mix, facts


def _read(run):
    return harness.load_module("metrics", "k14_roofline").read(run)


def _events(resolver=K14):
    """Two calls wholly inside the window, each two pieces of K13 and the
    resolver (K14, or a library kernel), and a call cut by the window's
    end."""
    ev = [_span(trace.WINDOW, 1000, 1000)]
    for t0 in (1100, 1500):
        ev += [_span("session.render_posed", t0, 300), _span("posed.script_plates", t0, 200)]
        for p0 in (t0, t0 + 100):
            ev += [_span("posed.script_piece", p0, 90), _span(K13, p0, 30, "kernel"),
                   _span(resolver, p0 + 30, 40, "kernel")]
    ev += [_span("session.render_posed", 1950, 100), _span("posed.script_plates", 1950, 80),
           _span(K13, 1950, 20, "kernel"), _span(resolver, 1975, 60, "kernel")]
    return ev


def _cell():
    _, cfg, mix = harness.resolve(SPEC, CELL)
    return cfg, mix


def test_the_metric_is_the_kernels_layers_and_the_script_cells():
    entry = next(m for m in SPEC["per_layer"] if m["name"] == "k14_roofline")
    assert entry == {"name": "k14_roofline", "unit": "%", "better": "higher",
                     "source": "device_trace", "layer": "kernels", "moves": "screens_per_s",
                     "workloads": [CELL]}
    assert SPEC["per_layer"][-1] is entry


def test_k14_roofline_reads_its_records_over_the_calls():
    cfg, mix = _cell()
    run = _Run(_events(), cfg, mix, {"k13_bytes": 1})
    per_call = k14_bytes.nbytes(cfg["width"] * cfg["height"], mix["batch"])
    # 2 calls over four whole K14 records of 40 us; the one cut by the
    # window's end is left out with its call
    assert _read(run) == pytest.approx(100.0 * 2 * per_call / rooflines.HBM_BYTES_PER_S
                                       / 160e-6)


def test_the_build_grid_sets_the_rays():
    cfg, mix = _cell()
    a = _read(_Run(_events(), cfg, mix, {"k13_bytes": 1}))
    b = _read(_Run(_events(), {**cfg, "render_scale": 2}, mix, {"k13_bytes": 1}))
    assert b == pytest.approx(a / 4)


def test_the_count_is_the_kernel_tables():
    # PERF.md's K14 row: 13 bytes a pose and ray at 1080p, the cell's B =
    # 1024 (2,123,366,400 pose-rays), and at chip_smoke's B = 64
    assert k14_bytes.nbytes(1920 * 1080, 1024) == 27_603_763_200
    assert k14_bytes.nbytes(1920 * 1080, 64) == 1_725_235_200
    assert k14_bytes.nbytes(1920 * 1080, 1024) / rooflines.HBM_BYTES_PER_S == pytest.approx(
        8.2399e-3, rel=1e-4)


def test_nothing_without_k14_records_the_span_or_the_cells_counts():
    """The parent's program evaluates the script with library kernels: no
    K14 record, no value and no error; nor without a trace, without the
    script stage's spans, or outside the script cell (no K13 count)."""
    cfg, mix = _cell()
    facts = {"k13_bytes": 1}
    assert _read(_Run(_events(LIB), cfg, mix, facts)) is None
    run = _Run(_events(), cfg, mix, facts)
    run.trace = None
    assert _read(run) is None
    no_spans = [e for e in _events() if not e["name"].startswith("posed.script")]
    assert _read(_Run(no_spans, cfg, mix, facts)) is None
    assert _read(_Run(_events(), cfg, mix, {})) is None
    no_records = [e for e in _events() if e["cat"] != "kernel"]
    assert _read(_Run(no_records, cfg, mix, facts)) is None
