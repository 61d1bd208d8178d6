"""End-to-end example: reproject a recorded 360° cubemap sequence.

This walks the full product pipeline on synthetic data — the same flow a
real workload uses with recorded cubemap frames (e.g. exported via
``f_saveglobe`` from the reference engine, or any cubemap video source):

1. synthesize a "demo" (recorded cubemap sequence + camera-pose track);
2. open a Session and pick a lens with the reference's console language;
3. batch-reproject with the rubix indicatrix, a panned view, and RGB
   output;
4. write PPM frames (feed them to ffmpeg for video).

Run:  python blinky_tpu_torch/examples/360_video.py [outdir] [device]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.io.dataset import FrameBatchIterator, write_demo, read_demo
from blinky_tpu_torch.io.ppm import encode_ppm
from blinky_tpu_torch.kernels.remap import expand_frames_tinted, host_array
from blinky_tpu_torch.palette import default_palette
from blinky_tpu_torch.utils.timing import FrameClock

W, H, S, N, BATCH = 640, 360, 256, 48, 16
DEVICE = "cuda"  # main(outdir, device="cpu") runs the plain versions


def main(outdir="warped_example", device=None):
    device = DEVICE if device is None else device
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    # 1. a recorded cubemap sequence with a slow pan (the demo container)
    base = synthetic_cubemap(S)
    frames = np.stack([np.roll(base, 3 * i, axis=2) for i in range(N)])
    poses = np.stack([np.zeros(N), np.linspace(0, 90, N), np.zeros(N)], axis=1)
    write_demo(out / "demo.npz", frames, default_palette(), poses)
    demo = read_demo(out / "demo.npz")

    # 2. a session speaking the reference's console vocabulary
    sess = Session(W, H, device=device, platesize=S, palette=demo["palette"])
    sess.cmd("f_lens stereographic; f_fov 300")
    sess.cmd("f_rubix")  # show the plate indicatrix

    # 3. batched reprojection with TRUE per-frame poses: one fused device
    #    call per chunk builds every frame's own lensmap and remaps it
    #    (kernels/posed.py; the reference recomposes plate cameras from
    #    viewangles every frame — F_RenderView, fisheye.c:750,777-792)
    clock = FrameClock()
    wrote = 0
    for batch, n_valid in FrameBatchIterator(demo["frames"], BATCH):
        B = batch.shape[-1]
        pidx = np.minimum(np.arange(wrote, wrote + B), N - 1)
        batch = expand_frames_tinted(batch, sess.palette)  # rubix fast path
        screens = host_array(sess.render_posed(batch, demo["poses"][pidx]))
        clock.tick(n_valid)
        # 4. export
        for b in range(n_valid):
            rgb = sess.palette[screens[b]]
            (out / f"frame{wrote:05d}.ppm").write_bytes(encode_ppm(rgb))
            wrote += 1
    print(clock.report())
    print(f"wrote {wrote} frames to {out}/ — e.g.:")
    print(f"  ffmpeg -i {out}/frame%05d.ppm -pix_fmt yuv420p pan.mp4")


if __name__ == "__main__":
    main(*sys.argv[1:])
