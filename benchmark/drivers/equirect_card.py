"""``Session.render_equirect`` of packed-RGBA pano batches already on the
card, bilinear, closed loop, one caller, no sync between calls but at the
window's end.

Mix keys: ``batch``, ``ring``, ``mode`` (``compact``, ``fused`` or
``faces``), ``check_sample``
(outputs of the window kept for the check, every lane of each), ``limits``."""

from __future__ import annotations

import torch

from benchmark import compare, program, rooflines, sources
from benchmark.drivers._ring import drain, release, step  # noqa: F401
from benchmark.reference import equirect as ref_equirect
from benchmark.reference import lensmap as ref_lensmap

# the program's span around each call this driver makes
ENTRY_SPAN = "session.render_equirect"

BACKGROUND = -(1 << 24)  # palette colour 0 (black) as packed RGBA, alpha 0xFF


class _Reference:
    """The screens of pano batches: the lensmap, the taps of each texel it
    names, the blend and the background select."""

    def __init__(self, run, hi=torch.float64, lo=torch.float32):
        c = run.cfg
        self.shape = (c["height"], c["width"])
        flat, self.valid = ref_lensmap.build(c["lens"], c["globe"], c["fov"], c["width"],
                                             c["height"], c["platesize"], hi=hi,
                                             device=run.device)
        self.texels, self.inv = torch.unique(flat[self.valid], return_inverse=True)
        self.rows, self.w, self.on_globe = ref_equirect.taps(
            c["globe"], c["platesize"], c["pano_h"], c["pano_w"], self.texels, hi=hi, lo=lo)
        self.lo = lo

    def __call__(self, panos):
        B = panos.shape[-1]
        src = panos.view(torch.int32).reshape(-1, B)
        texel = ref_equirect.blend(src[self.rows], self.w, lo=self.lo)
        texel = torch.where(self.on_globe[:, None], texel, 0)
        out = torch.full((self.valid.numel(), B), BACKGROUND, dtype=torch.int32,
                         device=texel.device)
        out[self.valid] = texel[self.inv]
        return out


def setup(run, control=False):
    st = run.state
    c, m = run.cfg, run.mix
    st["src"] = sources.pano_batches(c["pano_h"], c["pano_w"], m["batch"], m["ring"],
                                     run.seed, run.device)
    if control:
        ref = _Reference(run, hi=torch.float32, lo=torch.bfloat16)
        st["render"] = lambda p: ref(p).reshape(ref.shape + (p.shape[-1],))
    else:
        sess = st["session"] = program.session(c, run.device)
        st["render"] = lambda p: sess.render_equirect(p, bilinear=True, mode=m["mode"])
    for src in st["src"]:
        st["render"](src)


def check(run):
    st = run.state
    kept = release(run)
    ref = _Reference(run)
    worst = 0.0
    for slot, out in kept:
        B = out.shape[-1]
        expect = ref(st["src"][slot])
        worst = max(worst, compare.worst_lane_mismatch(
            out.view(torch.int32).reshape(-1, B), expect))
        del expect
    run.checks.append(("screen_mismatch", worst, run.mix["limits"]["screen_mismatch"]))
    B = run.mix["batch"]
    n = int(ref.texels.numel())
    pano_rows = int(torch.unique(ref.rows).numel())
    run.facts["k10_bytes"] = rooflines.equirect_gather_bytes(pano_rows, n, B)
    run.facts["k1_bytes"] = rooflines.gather_bytes(n, ref.valid.numel(), B, 4)
