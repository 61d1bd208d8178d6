"""``correct`` comes out false for the control and for each fault a cell
can have, with the rest of a run driven as it is (on the CPU, at a tiny
size, without the look for a card)."""

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import SMALL_CFG, SMALL_MIX
from blinky_tpu_torch import api

SPEC = harness.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def _run(cell, seed=2**31 + 3):
    res, _ = harness.run_cell(SPEC, cell, seed, 0.3, False, device="cpu",
                              t_start=time.perf_counter(), cfg_override=SMALL_CFG,
                              mix_override=SMALL_MIX)
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(cell):
    _, _, mix = harness.resolve(SPEC, cell)
    limit = mix["limits"]["screen_mismatch"]
    readings = list(control.readings(cell, [1, 2, 3], 0.2, False, device="cpu",
                                     cfg_override=SMALL_CFG, mix_override=SMALL_MIX,
                                     spec=SPEC))
    assert all(r["screen_mismatch"] > limit for _, r in readings), readings


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_passes(cell):
    assert _run(cell)["correct"] is True


def _half_batch(out):
    """Half of the lanes left out: they show zeros."""
    out = out.clone()
    out[..., out.shape[-1] // 2:] = 0
    return out


def _altered(out):
    """The first lane's screen altered where it is produced: shifted a row."""
    out = out.clone()
    out[..., 0] = torch.roll(out[..., 0], 1, dims=0)
    return out


def _patch(monkeypatch, name, fault):
    orig = getattr(api.Session, name)
    monkeypatch.setattr(api.Session, name, lambda self, *a, **k: fault(orig(self, *a, **k)))


@pytest.mark.parametrize("cell,entry", [("pc1080.batch_card", "render"),
                                        ("v360.compact_card", "render_equirect")])
@pytest.mark.parametrize("fault", [_half_batch, _altered])
def test_a_batch_fault_is_caught(monkeypatch, cell, entry, fault):
    _patch(monkeypatch, entry, fault)
    assert _run(cell)["correct"] is False
