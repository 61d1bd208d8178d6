"""Round-3 example: a reference-format `.lua` lens as a first-class citizen.

The reference's whole scripting promise is that a user drops a Lua file
in `lua-scripts/lenses/` and EVERYTHING works on it — the one lensmap
builder serves every lens (`fisheye.c:1659-1750`).  This example drives
that promise end-to-end here:

1. write a custom `.lua` lens (using the full late-round-3 Lua 5.2
   surface: `ipairs`, varargs, `string.format`, string PATTERNS for
   config parsing, and a metatable class for the ray math);
2. load it with the reference console vocabulary (plus round-3 `alias`);
3. render the exact float64 host path;
4. rotate the view — the SAME script runs through the float32
   device builder (its tensor mode) for ms-scale rebuilds;
5. per-frame pose playback (`render_posed`) on the script;
6. a fused `f_fov` zoom ramp (one device dispatch for the whole ramp);
7. a time-sliced exact build (`build_budget_s`): render immediately on
   the f32 preview while the exact table lands behind it.

Run:  python blinky_tpu_torch/examples/lua_drop_in.py [outdir] [device]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # repo root

import numpy as np

from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap
from blinky_tpu_torch.io.gif import encode_gif
from blinky_tpu_torch.kernels.posed import zoom_sweep_remap
from blinky_tpu_torch.kernels.remap import host_array
from blinky_tpu_torch.lensmap import Zoom, calc_scale

W, H, S = 160, 120, 120
DEVICE = "cuda"  # main(outdir, device="cpu") runs the plain versions
STEPS = 6

MY_LENS = """
-- a panini-family lens with a tunable squeeze, exercising the round-3
-- mini-Lua surface (generic for, varargs, string.format) plus the
-- late-round-3 full-language surface: string patterns parse the
-- defaults, a metatable class carries the ray math -- and the script
-- still traces onto the jitted device builder (Lua->JAX)
max_fov = 360
max_vfov = 180
CONFIG = "profile: fov=180; squeeze=0.15"
onload = "f_fov " .. string.match(CONFIG, "fov=(%d+)")

squeeze = {1.0, tonumber(string.match(CONFIG, "squeeze=([%d%.]+)"))}

Ray = {}
Ray.__index = Ray
function Ray.new(x, y, z) return setmetatable({x = x, y = y, z = z}, Ray) end
Ray.__mul = function(r, s) return Ray.new(r.x * s, r.y * s, r.z * s) end

function wsum(...)
  local t = 0
  for i, v in ipairs({...}) do t = t + v end
  return t
end

print(string.format("mylens loaded (squeeze sum %.2f)", wsum(1.0, 0.15)))

function lens_forward(x, y, z)
  local lon = math.atan2(x, z)
  local s = wsum(squeeze[1], squeeze[2] * math.cos(lon))
  local d = 1
  local clon = math.cos(lon)
  local S_ = math.sin(lon)
  local px = (d + 1) * S_ / (clon + d) * s
  local py = (d + 1) * (y / math.sqrt(x * x + z * z)) / (clon + d)
  return px, py
end

function lens_inverse(x, y)
  -- plain panini inverse (d = 1); the squeeze is forward-only here
  local d = 1
  local k = x * x / ((d + 1) * (d + 1))
  local dscr = k * k * d * d - (k + 1) * (k * d * d - 1)
  local clon = (-k * d + math.sqrt(dscr)) / (k + 1)
  local S_ = (d + clon) / (d + 1)
  local lon = math.atan2(x / (d + 1), S_ * clon)
  if math.abs(lon) > math.pi / 2 * 2 then return nil end
  -- a metatabled Ray scaled through __mul (constructed inside the
  -- masked region above: the fresh-install allowance keeps this on
  -- the vectorized/traced path)
  local r = Ray.new(math.sin(lon), y, math.cos(lon)) * S_
  return r.x, r.y, r.z
end
"""


def main(outdir, device=None):
    device = DEVICE if device is None else device
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "mylens.lua").write_text(MY_LENS)

    frames = synthetic_cubemap(S)

    # --- load + exact host render, with a round-3 alias
    sess = Session(W, H, device=device, platesize=S, lens_dirs=[outdir], echo=True)
    sess.cmd('alias wide "f_fov 300"')
    sess.cmd("f_lens mylens")
    print("jittable (tensor-mode probe):", sess.lens.jittable)
    exact = host_array(sess.render(frames))
    sess.cmd("wide")  # alias expansion
    wide = host_array(sess.render(frames))
    assert (exact != wide).any()

    # --- the SAME script through the f32 device builder (view rotation)
    sess.cmd("f_fov 180; setviewangles 10 35 0")
    assert sess._resolved_backend() == "torch"
    host_array(sess.render(frames))

    # --- per-frame pose playback (previously .lua lenses were refused)
    poses = np.stack([np.zeros(4), np.linspace(0, 90, 4), np.zeros(4)], 1)
    posed = host_array(sess.render_posed(frames[..., None].repeat(4, -1),
                                         poses))
    print("render_posed on the .lua lens:", posed.shape)

    # --- fused zoom ramp: one device dispatch for the whole sweep
    sess.cmd("setviewangles")
    scales = [calc_scale(Zoom("fov", int(v)), sess.lens, W, H)
              for v in np.linspace(120, 330, STEPS)]
    ramp = host_array(zoom_sweep_remap(sess.lens, sess.globe, scales,
                                       frames, W, H, device=device))
    (outdir / "sweep.gif").write_bytes(
        encode_gif(np.moveaxis(ramp, 0, -1), sess.palette, delay_cs=12))
    print("fused ramp:", ramp.shape, "->", outdir / "sweep.gif")

    # --- time-sliced exact build: render NOW on the preview, exact lands
    sliced = Session(W, H, device=device, platesize=S, lens_dirs=[outdir],
                     build_budget_s=1 / 60)
    sliced.cmd("f_lens mylens")
    first = host_array(sliced.render(frames))  # f32 preview, instant
    out = first  # tiny grids may finish inside the first slice
    n = 0
    while sliced.build_progress is not None and n < 10_000:
        out = host_array(sliced.render(frames))
        n += 1
    print(f"exact table landed after {n} sliced renders; "
          f"preview/exact pixel agreement: "
          f"{(first == out).mean() * 100:.2f}%")
    assert np.array_equal(out, exact)
    return outdir


if __name__ == "__main__":
    main(*(sys.argv[1:] or ["lua_drop_in_out"]))
