"""Non-blocking first render example: previews while the table builds.

The reference never blocks the frame loop — all lensmap build work is
time-sliced across frames (``fisheye.c:306-322``).  Round 5 extends
that discipline to the one remaining seconds-scale cost: a forward-only
lens's first posed render pays a host rasterization to reconstruct its
per-pixel ray table (~2 s at 1080p).  ``render_posed(block=False)``
kicks that build on a background thread and serves geometry-correct
coarse-``render_scale`` previews of the SAME poses until it lands
(poll ``Session.posed_pending``); from then on outputs are identical
to ``block=True``.

Run:  python blinky_tpu_torch/examples/async_preview.py [outdir] [device]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.io.ppm import encode_ppm
from blinky_tpu_torch.kernels.remap import host_array

W, H, S, N = 640, 480, 480, 12
DEVICE = "cuda"  # main(outdir, device="cpu") runs the plain versions
LENS = "sinusoidal"  # forward-only: the first posed call builds a table


def main(outdir="async_out", device=None):
    device = DEVICE if device is None else device
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    sess = Session(W, H, device=device, platesize=S)
    sess.cmd(f"f_lens {LENS}")

    base = synthetic_cubemap(S)
    frames = np.stack([base] * N, axis=-1)  # [P, S, S, N]
    t = np.linspace(0.0, 1.0, N)
    poses = np.stack([np.zeros(N), 60 * t, np.zeros(N)], axis=1)

    # first call: returns a coarse preview without paying the native-res
    # ray-table rasterization, which runs on a background thread.  (What
    # block=False removes is the TABLE build; the preview still pays the
    # kernels' one-time build when the process is cold — warm production
    # processes return in tens of ms here.)
    t0 = time.perf_counter()
    preview = host_array(sess.render_posed(frames, poses, block=False))
    t_first = time.perf_counter() - t0
    print(f"first call returned in {t_first * 1000:.0f} ms "
          f"(pending={sess.posed_pending}) — preview {preview.shape}")

    # an interactive host would keep rendering previews here; we just
    # poll until the exact-resolution kernel swaps in
    while sess.posed_pending:
        time.sleep(0.05)
    t0 = time.perf_counter()
    final = host_array(sess.render_posed(frames, poses, block=False))
    t_swapped = time.perf_counter() - t0
    print(f"native kernel swapped in; posed batch now {t_swapped * 1000:.0f} ms")

    # once pending clears, block=False output IS the block=True output
    ref = host_array(sess.render_posed(frames, poses))
    print("swapped-in == blocking:", bool(np.array_equal(final, ref)))

    rgb = sess.palette[final]
    for i in range(N):
        (outdir / f"async{i:03d}.ppm").write_bytes(encode_ppm(rgb[i]))
    print(f"wrote {N} frames to {outdir}/")


if __name__ == "__main__":
    main(*sys.argv[1:] or ["async_out"])
