"""Per-frame-pose playback example: every lens rotates on device.

The reference re-renders its camera plates every frame, so any lens —
even the 10 map projections that only define a FORWARD mapping — pans
at full frame rate (``F_RenderView``, ``fisheye.c:750,2427-2450``).
Round 4 reproduces that for recorded cubemaps with the static-ray
recomposition (``kernels/static_ray.py``): one per-pixel camera-ray
table per (lens, zoom, size), then each pose is a lens-free
rotate + plate-resolve + gather fused on device.

This example plays a pose track through ``eckert1`` — a forward-only
lens, whose exact path rasterizes on the host once a pose — on the card
(K7 and K6), and compares one pose against that exact path.

Run:  python blinky_tpu_torch/examples/pose_playback.py [outdir] [device]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.io.ppm import encode_ppm
from blinky_tpu_torch.kernels.remap import host_array
from blinky_tpu_torch.utils.timing import FrameClock

W, H, S, N = 640, 480, 480, 24
DEVICE = "cuda"  # main(outdir, device="cpu") runs the plain versions
LENS = "eckert1"  # forward-only: no lens_inverse in the script


def main(outdir="pose_out", device=None):
    device = DEVICE if device is None else device
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    sess = Session(W, H, device=device, platesize=S)
    sess.cmd(f"f_lens {LENS}")

    # a recorded cubemap "video": one synthetic frame per pose here; a
    # real workload feeds per-frame f_saveglobe dumps or 360 footage
    base = synthetic_cubemap(S)
    frames = np.stack([np.roll(base, 2 * i, axis=2) for i in range(N)],
                      axis=-1)  # [P, S, S, N], batch-innermost
    t = np.linspace(0.0, 1.0, N)
    poses = np.stack([8 * np.sin(2 * np.pi * t),   # pitch bob
                      90 * t,                      # yaw pan
                      np.zeros(N)], axis=1)

    clock = FrameClock()
    screens = host_array(sess.render_posed(frames, poses))  # [N, H, W]
    clock.tick(N)
    print(f"{N} poses through {LENS} (device static-ray path): "
          f"{clock.fps:.1f} fps")

    # spot-check one rotated pose against the per-pose exact host path
    # (the identity pose is bit-exact; rotated poses re-resolve the
    # rasterized map by nearest ray — see docs/PERF.md)
    j = min(5, N - 1)
    exact = host_array(sess.render_posed(frames[..., j:j + 1], poses[j:j + 1],
                                         exact=True))
    agree = (screens[j] == exact[0]).mean()
    print(f"pose {j} vs exact host rasterization: {agree:.1%} identical")

    rgb = sess.palette[screens]  # palette-decode for viewing
    for i in range(N):
        (outdir / f"pose{i:03d}.ppm").write_bytes(encode_ppm(rgb[i]))
    print(f"wrote {N} frames to {outdir}/ "
          "(ffmpeg -i pose%03d.ppm out.mp4)")


if __name__ == "__main__":
    main(*sys.argv[1:] or ["pose_out"])
