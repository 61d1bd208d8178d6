"""Pan inside a 360° video: equirect ingest feeding posed playback.

The two round-4 pipelines compose into the canonical 360°-viewer flow —
look around inside an equirectangular video while it plays:

1. ``EquirectIngest`` resamples each pano onto the globe's plates ON
   DEVICE (a static 4-tap gather table, ``kernels/ingest.py``);
2. ``Session.render_posed`` plays a camera-pose track over the ingested
   plate batch through the static-ray pipeline (``kernels/static_ray.py``)
   — per pose a lens-free rotate + plate-resolve + gather, every lens
   including the 10 forward-only map projections;
3. warped true-color screens are all that leaves the chip.

The same flow ships in the product surface too: ``cli demo-import
--equirect N --poses track.txt`` builds a demo container from panorama
files + a pose track, ``cli reproject --follow-poses`` plays it, and
``cli serve`` drag-looks live (forward-only lenses ride this exact
posed path — the reference pans by re-rendering plates,
``fisheye.c:750,2427-2450``, never by rebuilding its lensmap).

Run:  python blinky_tpu_torch/examples/pano_pan.py [outdir] [device]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.png import encode_png
from blinky_tpu_torch.kernels.ingest import EquirectIngest
from blinky_tpu_torch.kernels.remap import host_array, pack_rgba, unpack_rgb
from blinky_tpu_torch.utils.timing import FrameClock

W, H, S, N = 640, 360, 256, 24
DEVICE = "cuda"  # main(outdir, device="cpu") runs the plain versions
PANO_H, PANO_W = 512, 1024
LENS = "panini"


def synth_panos(n):
    """A drifting color field as an equirect 'video' ([H, W, N] u32)."""
    yy, xx = np.mgrid[0:PANO_H, 0:PANO_W]
    frames = []
    for i in range(n):
        r = ((xx * 255) // PANO_W + 5 * i) % 256
        g = ((yy * 255) // PANO_H) % 256
        b = ((xx + yy + 7 * i) // 4) % 256
        frames.append(np.stack([r, g, b], axis=-1).astype(np.uint8))
    return np.moveaxis(pack_rgba(np.stack(frames)), 0, -1)


def main(outdir="pano_pan_out", device=None):
    device = DEVICE if device is None else device
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    sess = Session(W, H, device=device, platesize=S)
    sess.cmd(f"f_lens {LENS}")

    panos = synth_panos(N)  # [PANO_H, PANO_W, N] packed-RGBA u32
    ingest = EquirectIngest(PANO_H, PANO_W, S, globe=sess.globe,
                            bilinear=True, device=device)
    faces = ingest(panos)  # [P, S, S, N] u32, one per pano — DEVICE-
    # resident: render_posed passes device arrays through (like
    # render()), so no host round-trip between the two pipelines

    # the camera track: a slow look-around while the video plays
    t = np.linspace(0.0, 1.0, N)
    poses = np.stack([15 * np.sin(2 * np.pi * t),  # pitch bob
                      120 * t - 60,                # yaw sweep
                      np.zeros(N)], axis=1)

    _ = host_array(sess.render_posed(faces, poses))  # compile + warm
    clock = FrameClock()
    screens = host_array(sess.render_posed(faces, poses))  # [N, H, W] u32
    clock.tick(N)
    print(f"{N} panos panned through {LENS}: {clock.fps:.1f} fps warm "
          f"(pano -> plates -> warped screens, device-resident)")

    for i, screen in enumerate(screens):
        (outdir / f"pan_{i:04d}.png").write_bytes(
            encode_png(unpack_rgb(screen)))
    print(f"wrote {N} PNGs to {outdir}/ (ffmpeg-ready)")


if __name__ == "__main__":
    main(*sys.argv[1:])
