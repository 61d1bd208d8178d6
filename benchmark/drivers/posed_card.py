"""``Session.render_posed`` of u8 frame batches already on the card, each
frame at its own pose, closed loop, one caller, no sync between calls but
at the window's end.

The deployment converts a recorded demo whose whole angle track is known
before rendering starts, so each ring slot's track becomes ``[B, 3, 3]``
bases once, in set-up (``benchmark/poses.py``), put on the card in float32
as ``render_posed`` casts them, and every call passes its slot's bases
there, at the configuration's ``render_scale`` and ``exact``: a call
uploads nothing, so the host queues calls ahead of the card.  A
``render_posed`` that reads bases only through NumPy cannot take them, and
the run fails in its set-up.  The float64 bases stay on the host for the
check; the control is given them on the card in float64 and casts them
itself.

Mix keys: ``batch`` (frames a call), ``ring`` (distinct seeded batches and
tracks, used in turn), ``check_sample`` (outputs of the window kept for the
check, every lane of each), ``limits``."""

from __future__ import annotations

import torch

from benchmark import compare, k6_ops, k7_bytes, poses, program, sources
from benchmark.drivers._ring import drain, release  # noqa: F401
from benchmark.reference import lensmap as ref_lensmap
from benchmark.reference import posed as ref_posed

# the program's span around each call this driver makes
ENTRY_SPAN = "session.render_posed"


def setup(run, control=False):
    st = run.state
    c, m = run.cfg, run.mix
    st["src"] = sources.cubemap_batches(c["platesize"], m["batch"], m["ring"], run.seed,
                                        run.device)
    st["bases"] = [poses.bases(t) for t in poses.tracks(run.seed, m["ring"], m["batch"], c)]
    dtype = torch.float64 if control else torch.float32
    st["given"] = [torch.as_tensor(b, dtype=dtype, device=run.device) for b in st["bases"]]
    if control:
        st["render"] = ref_posed.Posed(c, run.device, hi=torch.float32, lo=torch.bfloat16)
    else:
        sess = st["session"] = program.session(c, run.device)
        st["render"] = lambda src, b: sess.render_posed(src, b, render_scale=c["render_scale"],
                                                        exact=c["exact"])
    for src, b in zip(st["src"], st["given"]):  # the ray table, the kernel, the library
        st["render"](src, b)


def step(run):
    """One call on the next ring slot; its screens are ``[B, H, W]``, one a
    frame."""
    st = run.state
    if run.calls == 0:
        st["sample"] = sources.Reservoir(run.mix["check_sample"], run.seed)
    slot = run.calls % len(st["src"])
    with run.spans("bench.render"):
        out = st["render"](st["src"][slot], st["given"][slot])
    st["sample"].offer((slot, out))
    run.calls += 1
    run.screens += out.shape[0]


def check(run):
    st = run.state
    kept = release(run)
    c = run.cfg
    ref = ref_posed.Posed(c, run.device)
    worst = 0.0
    for slot, out in kept:
        src, bases = st["src"][slot], st["bases"][slot]
        B = src.shape[-1]
        if tuple(out.shape) != (B,) + ref.shape:
            worst = 1.0
            continue
        for start in range(0, B, ref_posed.BLOCK):
            stop = min(start + ref_posed.BLOCK, B)
            expect = ref.screens(src, bases, start, stop)
            worst = max(worst, compare.worst_lane_mismatch(
                out[start:stop].reshape(stop - start, -1).t(), expect.t()))
            del expect
    run.checks.append(("screen_mismatch", worst, run.mix["limits"]["screen_mismatch"]))
    P, S, _, B = st["src"][0].shape
    run.facts["k6_ops"] = k6_ops.ops(ref.pixels, B, ref_lensmap.globe(c["globe"]).numplates)
    run.facts["k7_bytes"] = k7_bytes.nbytes(P, S, B)
