"""``Session.render_posed`` through a user's Lua globe: u8 frame batches of
the globe's plates, already on the card, each frame at its own pose,
closed loop, one caller, no sync between calls but at the window's end.

The configuration holds the globe's script (``script``) under its name
(``globe``); set-up writes it as ``<globe>.lua`` into a directory of its
own, gives that directory to the Session as its ``globe_dirs`` and takes
the globe with ``f_globe``, as a user drops a script into the engine's
``globes`` folder.  A frame holds the
configuration's ``planes`` plates, ``[planes, S, S, B]``.  The pose tracks
and their bases are made once a ring slot in set-up, as in
``posed_card.py``, and each call passes its slot's float32 bases on the
card, so a call uploads nothing.  The check compares with
:class:`benchmark.reference.globe_fastlua.FastLuaPosed`, the script's
equations written again; the control is that reference one precision
down.

Mix keys: ``batch`` (frames a call), ``ring`` (distinct seeded batches and
tracks, used in turn), ``check_sample`` (outputs of the window kept for the
check, every lane of each), ``limits``."""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from benchmark import compare, k6_ops_given, k13_bytes, poses, program, sources
from benchmark.drivers._ring import drain, release  # noqa: F401
from benchmark.drivers.posed_card import step  # noqa: F401
from benchmark.reference import globe_fastlua
from benchmark.reference import posed as ref_posed

# the program's span around each call this driver makes
ENTRY_SPAN = "session.render_posed"
FRAME_STREAM = 1  # the seed's stream of the frames (sources.stream_seed)


def frame_batches(planes: int, platesize: int, batch: int, ring: int, seed: int,
                  device) -> list:
    """*ring* batches of u8 palette frames ``[planes, S, S, B]`` on
    *device*, made from *seed*."""
    g = sources.generator(seed, FRAME_STREAM, device)
    return [sources.random_bytes((planes, platesize, platesize, batch), g, device)
            for _ in range(ring)]


def session(cfg: dict, device, globe_dir: Path):
    """The configuration's Session (``program.session``) at Blinky's default
    globe, the cube, that then finds the configuration's globe script in
    *globe_dir* (its ``globe_dirs``) and takes it with ``f_globe``, as a
    user who drops a script into the engine's ``globes`` folder does."""
    (globe_dir / f"{cfg['globe']}.lua").write_text(cfg["script"])
    sess = program.session({**cfg, "globe": "cube"}, device)
    sess.globe_dirs = [globe_dir]
    sess.cmd(f"f_globe {cfg['globe']}")
    return sess


def setup(run, control=False):
    st = run.state
    c, m = run.cfg, run.mix
    st["src"] = frame_batches(c["planes"], c["platesize"], m["batch"], m["ring"], run.seed,
                              run.device)
    st["bases"] = [poses.bases(t) for t in poses.tracks(run.seed, m["ring"], m["batch"], c)]
    dtype = torch.float64 if control else torch.float32
    st["given"] = [torch.as_tensor(b, dtype=dtype, device=run.device) for b in st["bases"]]
    if control:
        st["render"] = globe_fastlua.FastLuaPosed(c, run.device, hi=torch.float32,
                                                  lo=torch.bfloat16)
    else:
        st["globe_dir"] = tempfile.TemporaryDirectory(prefix="bench_globes_")
        sess = st["session"] = session(c, run.device, Path(st["globe_dir"].name))
        st["render"] = lambda src, b: sess.render_posed(src, b, render_scale=c["render_scale"],
                                                        exact=c["exact"])
    for src, b in zip(st["src"], st["given"]):  # the ray table, the kernel, the library
        st["render"](src, b)


def check(run):
    st = run.state
    kept = release(run)
    if "globe_dir" in st:
        st.pop("globe_dir").cleanup()
    ref = globe_fastlua.FastLuaPosed(run.cfg, run.device)
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
    B = st["src"][0].shape[-1]
    run.facts["k6_ops"] = k6_ops_given.ops(ref.pixels, B)
    run.facts["k13_bytes"] = k13_bytes.nbytes(ref.pixels, B)
