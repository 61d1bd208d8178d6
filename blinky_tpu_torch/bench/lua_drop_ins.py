"""Four ``.lua`` drop-ins that exercise the Lua bridge's device paths.

Written for the port's tests and ``chip_smoke.py`` (not the reference's
scripts, which this repository does not hold):

* ``lpanini.lua``: the panini lens, transcribed from
  ``blinky_tpu/lenses/panini.py`` in its operation order, so its builds
  equal the built-in panini's;
* ``lnewton.lua``: a lens whose inverse runs Newton's method in a
  data-dependent ``repeat ... until`` loop (winkeltripel's shape), the
  tensor mode's masked loop;
* ``lfast.lua``: the ``fast`` globe, its plates and its ``globe_plate``
  transcribed from ``blinky_tpu_torch/globes/builtin.py::_fast_resolver``,
  a script resolver on the device (resolver mode 2 of K6, K8 and K9);
* ``scat.lua``: a lens that writes a table at a lane-varying key, which
  needs per-lane control: it evaluates on no tensor (``jittable`` False)
  and builds on the exact host path.

:func:`write_scripts` writes them into a directory for ``lens_dirs`` /
``globe_dirs``.
"""

from __future__ import annotations

from pathlib import Path

LPANINI = """\
-- Panini (cylindrical stereographic, d = 1), in the operation order of
-- blinky_tpu/lenses/panini.py
max_fov = 360
max_vfov = 180
onload = "f_fov 180"
local d = 1

function lens_inverse(x, y)
  local k = x * x / ((d + 1) * (d + 1))
  local dscr = k * k * d * d - (k + 1) * (k * d * d - 1)
  local clon = (-k * d + sqrt(dscr)) / (k + 1)
  local s = (d + 1) / (d + clon)
  local lon = atan2(x, s * clon)
  local lat = atan2(y, s)
  return latlon_to_ray(lat, lon)
end

function lens_forward(x, y, z)
  local lat, lon = ray_to_latlon(x, y, z)
  local s = (d + 1) / (d + cos(lon))
  return s * sin(lon), s * tan(lat)
end
"""

LNEWTON = """\
-- A lens whose inverse solves y = lat + sin(lat) / 2 for lat by Newton's
-- method: a data-dependent repeat ... until loop, like winkeltripel's
max_fov = 360
max_vfov = 180
onload = "f_fov 180"

function lens_inverse(x, y)
  if math.abs(x) > math.pi or math.abs(y) > math.pi / 2 + 0.5 then
    return nil
  end
  local lat = y
  local n = 0
  repeat
    local step = (lat + 0.5 * math.sin(lat) - y) / (1 + 0.5 * math.cos(lat))
    lat = lat - step
    n = n + 1
  until math.abs(step) < 1e-6 or n >= 30
  return latlon_to_ray(lat, x)
end

function lens_forward(x, y, z)
  local lat, lon = ray_to_latlon(x, y, z)
  return lon, lat + 0.5 * math.sin(lat)
end
"""

LFAST = """\
-- The fast globe: a sharp 90-degree plate inside a wide 160-degree one,
-- transcribed from blinky_tpu_torch/globes/builtin.py (_fast_resolver)
plates = {
  { {0, 0, 1}, {0, 1, 0}, 90 },
  { {0, 0, 1}, {0, 1, 0}, 160 },
}
local big_fov = 160
local dist = 0.5 / math.tan(big_fov * math.pi / 180 / 2)
local size = 2 * dist * math.tan(math.pi / 4)
local half = size / 2

function globe_plate(x, y, z)
  if z <= 0 then
    return nil
  end
  local u = x / z * dist
  local v = y / z * dist
  if math.abs(u) < half and math.abs(v) < half then
    return 0
  end
  return 1
end
"""

SCAT = """\
-- A lens that writes a table at a lane-varying key: per-lane control, so
-- it runs on the scalar interpreter and builds on the exact host path
max_fov = 360
max_vfov = 180
onload = "f_fov 180"
acc = {}
function lens_forward(x, y, z)
  local lat, lon = ray_to_latlon(x, y, z)
  return lon / 1.5, lat / 1.5
end
function lens_inverse(x, y)
  local k = math.floor(math.abs(x) * 3) + 1
  acc[k] = y
  local r = 1.5
  return latlon_to_ray(y * r, x * r)
end
"""

LENSES = {"lpanini": LPANINI, "lnewton": LNEWTON, "scat": SCAT}
GLOBES = {"lfast": LFAST}


def write_scripts(directory) -> Path:
    """Write the four scripts as ``<name>.lua`` into *directory* (made if
    missing) and return it."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name, src in {**LENSES, **GLOBES}.items():
        (directory / f"{name}.lua").write_text(src)
    return directory
