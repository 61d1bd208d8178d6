"""True-color 360° pipeline example: equirect video in, warped PNGs out.

Most real 360° footage is equirectangular.  This example runs the whole
true-color path on synthetic panoramas:

1. synthesize an equirect pano sequence (a drifting color field);
2. `Session.render_equirect` warps each batch end-to-end on the device —
   pano→plates ingest (`kernels/ingest.py`, a static gather table) chained
   into the lens remap, so only warped screens leave the chip;
3. switch lenses with the reference's console vocabulary mid-stream;
4. render one supersampled (`render_aa`) poster frame;
5. write PNGs (stdlib codec — feed them to ffmpeg for video).

Run:  python blinky_tpu_torch/examples/equirect_pipeline.py [outdir] [device]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import equirect_to_cubemap
from blinky_tpu_torch.io.png import encode_png
from blinky_tpu_torch.kernels.remap import host_array, pack_rgba, unpack_rgb
from blinky_tpu_torch.utils.timing import FrameClock

W, H, PANO_W, PANO_H, S, N, BATCH = 640, 360, 1024, 512, 360, 24, 8
DEVICE = "cuda"  # main(outdir, device="cpu") runs the plain versions


def synth_pano(t: float) -> np.ndarray:
    """A smooth drifting color field with a horizon line."""
    yy, xx = np.mgrid[0:PANO_H, 0:PANO_W]
    r = (xx * 255 // (PANO_W - 1) + int(t * 40)) % 256
    g = yy * 255 // (PANO_H - 1)
    b = ((xx + yy) * 127 // (PANO_W + PANO_H)) + int(t * 15) % 128
    rgb = np.stack([r, g, b], axis=-1).astype(np.uint8)
    rgb[PANO_H // 2 - 1 : PANO_H // 2 + 1] = 255  # horizon
    return rgb


def main(outdir="warped_equirect", device=None):
    device = DEVICE if device is None else device
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    sess = Session(W, H, device=device, platesize=S)
    sess.cmd("f_lens stereographic; f_fov 250")

    clock = FrameClock()
    wrote = 0
    switched = False
    panos = np.stack([pack_rgba(synth_pano(i)) for i in range(N)], axis=-1)
    for i0 in range(0, N, BATCH):
        if wrote >= N // 2 and not switched:
            # lens switch mid-stream, like the console (batch boundaries
            # need not land exactly on N//2)
            switched = True
            sess.cmd("f_lens quincuncial; f_contain")
        batch = panos[..., i0 : i0 + BATCH]  # [PANO_H, PANO_W, B]
        screens = host_array(sess.render_equirect(batch))
        clock.tick(batch.shape[-1])
        for b in range(batch.shape[-1]):
            rgb = unpack_rgb(screens[..., b])
            (out / f"frame{wrote:05d}.png").write_bytes(encode_png(rgb))
            wrote += 1
    print(clock.report())

    # a supersampled poster frame through the hammer projection
    sess.cmd("f_lens hammer; f_contain")
    faces = equirect_to_cubemap(synth_pano(0), platesize=S)
    poster = host_array(sess.render_aa(faces, factor=2))
    (out / "poster_aa.png").write_bytes(encode_png(unpack_rgb(poster)))

    print(f"wrote {wrote} frames + poster_aa.png to {out}/ — e.g.:")
    print(f"  ffmpeg -i {out}/frame%05d.png -pix_fmt yuv420p warped.mp4")


if __name__ == "__main__":
    main(*sys.argv[1:])
