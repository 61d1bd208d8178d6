"""``Session.render`` of u8 frame batches already on the card, closed loop,
one caller, no sync between calls but at the window's end.

Mix keys: ``batch`` (frames a call), ``ring`` (distinct seeded batches,
used in turn, ``_ring.py``), ``check_sample``
(outputs of the window kept for the check, every lane of each), ``limits``."""

from __future__ import annotations

import torch

from benchmark import compare, program, rooflines, sources
from benchmark.drivers._ring import drain, release, step  # noqa: F401
from benchmark.reference import lensmap as ref_lensmap
from benchmark.reference import remap as ref_remap

# the program's span around each call this driver makes
ENTRY_SPAN = "session.render"


def _reference_render(run, hi):
    c = run.cfg
    flat, valid = ref_lensmap.build(c["lens"], c["globe"], c["fov"], c["width"], c["height"],
                                    c["platesize"], hi=hi, device=run.device)

    def render(src):
        B = src.shape[-1]
        return ref_remap.gather(src.reshape(-1, B), flat, valid, 0).reshape(
            c["height"], c["width"], B)

    return render


def setup(run, control=False):
    st = run.state
    st["src"] = sources.cubemap_batches(run.cfg["platesize"], run.mix["batch"],
                                        run.mix["ring"], run.seed, run.device)
    if control:
        st["render"] = _reference_render(run, torch.float32)
    else:
        st["session"] = program.session(run.cfg, run.device)
        st["render"] = st["session"].render
    for src in st["src"]:  # the exact lensmap, the kernel's operands, the library
        st["render"](src)


def check(run):
    st = run.state
    kept = release(run)
    c = run.cfg
    flat, valid = ref_lensmap.build(c["lens"], c["globe"], c["fov"], c["width"], c["height"],
                                    c["platesize"], device=run.device)
    worst = 0.0
    for slot, out in kept:
        src = st["src"][slot]
        B = src.shape[-1]
        ref = ref_remap.gather(src.reshape(-1, B), flat, valid, 0)
        worst = max(worst, compare.worst_lane_mismatch(out.reshape(-1, B), ref))
        del ref
    run.checks.append(("screen_mismatch", worst, run.mix["limits"]["screen_mismatch"]))
    rows = int(torch.unique(flat[valid]).numel())
    run.facts["k1_bytes"] = rooflines.gather_bytes(rows, flat.numel(), run.mix["batch"], 1)
