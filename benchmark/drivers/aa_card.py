"""``Session.render_aa`` of u8 frame batches already on the card at the
configuration's ``factor``, closed loop, one caller, no sync between calls
but at the window's end.

The session is the configuration's lens and globe, given a palette drawn
from the seed (:func:`palette`) through its ``palette`` property.  A call
decodes the frames through it to packed RGBA on the card, renders them at
``factor`` times the screen and box-filters the screens back down; it
returns ``[H, W, B]`` packed-RGBA words, a screen a frame.

Mix keys: ``batch`` (frames a call), ``ring`` (distinct seeded batches,
used in turn, ``_ring.py``), ``check_sample`` (outputs of the window kept
for the check, every lane of each), ``limits``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import aa_decode_bytes, compare, k11_bytes, program, rooflines, sources
from benchmark.drivers._ring import drain, release, step  # noqa: F401
from benchmark.reference import aa as ref_aa

# the program's span around each call this driver makes
ENTRY_SPAN = "session.render_aa"
PALETTE_STREAM = 7  # the seed's stream of the palette (sources.stream_seed)


def palette(seed: int) -> np.ndarray:
    """A ``[256, 3]`` u8 palette of uniform (r, g, b) entries, made from
    *seed*."""
    rng = np.random.default_rng(sources.stream_seed(seed, PALETTE_STREAM))
    return rng.integers(0, 256, (256, 3), dtype=np.uint8)


def setup(run, control=False):
    st = run.state
    c, m = run.cfg, run.mix
    st["src"] = sources.cubemap_batches(c["platesize"], m["batch"], m["ring"], run.seed,
                                        run.device)
    st["palette"] = palette(run.seed)
    if control:
        st["render"] = ref_aa.AA(c, st["palette"], hi=torch.float32, device=run.device)
    else:
        sess = st["session"] = program.session(c, run.device)
        sess.palette = st["palette"]
        st["render"] = lambda src: sess.render_aa(src, factor=c["factor"])
    for src in st["src"]:  # the exact hi-res lensmap, the kernels' operands, the libraries
        st["render"](src)


def check(run):
    st = run.state
    kept = release(run)
    c = run.cfg
    ref = ref_aa.AA(c, st["palette"], device=run.device)
    worst = 0.0
    for slot, out in kept:
        src = st["src"][slot]
        B = src.shape[-1]
        if tuple(out.shape) != ref.shape + (B,):
            worst = 1.0
            continue
        words = out.view(torch.int32).reshape(-1, B)
        for start in range(0, B, ref_aa.BLOCK):
            stop = min(start + ref_aa.BLOCK, B)
            expect = ref.screens(src, start, stop)
            worst = max(worst, compare.worst_lane_mismatch(words[:, start:stop], expect))
            del expect
    run.checks.append(("screen_mismatch", worst, run.mix["limits"]["screen_mismatch"]))
    P, S, _, B = st["src"][0].shape
    W, H, k = c["width"], c["height"], ref.factor
    rows = int(torch.unique(ref.flat[ref.valid]).numel())
    run.facts["k1_bytes"] = rooflines.gather_bytes(rows, ref.flat.numel(), B, 4)
    run.facts["k11_bytes"] = k11_bytes.nbytes(W, H, k, B)
    run.facts["aa_decode_bytes"] = aa_decode_bytes.nbytes(P, S, B)
