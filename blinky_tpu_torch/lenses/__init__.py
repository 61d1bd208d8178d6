"""Lenses: forward/inverse map projections melding plates into one image.

A lens is what the reference loads from ``game/lua-scripts/lenses/*.lua``
(loader: ``LUA_load_lens``, ``engine/NQ/fisheye.c:1659-1749``); the
contract is :mod:`blinky_tpu.lenses`'s:

* ``lens_inverse(x, y) -> (vx, vy, vz, valid)``;
* ``lens_forward(x, y, z) -> (px, py, valid)``;
* ``lens_width`` / ``lens_height``, ``max_fov`` / ``max_vfov``, ``map``
  and ``onload`` metadata, with the reference's map-type resolution.

User lenses are ``.py`` modules defining ``make(ctx)`` or the reference's
``.lua`` scripts (:func:`load_lens_module`).

Each lens lives in its own module defining ``make(ctx) -> dict``; its
mapping functions are dtype-generic array functions (see
:mod:`blinky_tpu_torch.xmath`), evaluated in float64 on NumPy by the exact
host builder and in float32 on tensors by the device builder.  The ten
forward-only lenses run on NumPy only, inside the host rasterizer
(:mod:`blinky_tpu_torch.lensmap.forward_raster`).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

# the built-ins, each a module of this package: all 31 of blinky_tpu's
BUILTIN_LENSES = [
    "cube", "cubestereo", "cylinder", "debug", "eckert1", "eckert4",
    "eckert5", "equirect", "fahey", "fisheye1", "fisheye2", "gallstereo",
    "gins8", "gumby", "hammer", "kavrayskiy7", "larrivee", "mercator",
    "miller", "mollweide", "panini", "polyconic", "quincuncial",
    "rectilinear", "sinusoidal", "stereographic", "vandergrinten", "wagner6",
    "winkel1", "winkel2", "winkeltripel",
]


@dataclasses.dataclass(frozen=True, eq=False)
class LensDef:
    """A loaded lens: resolved mapping functions + metadata."""

    name: str
    forward: Optional[Callable]  # (x, y, z) -> (px, py, valid)
    inverse: Optional[Callable]  # (x, y) -> (vx, vy, vz, valid)
    map_type: str  # "inverse" | "forward"
    width: float  # lens-plane width, 0 = unspecified
    height: float
    max_fov: int
    max_vfov: int
    onload: Optional[str]
    # False for a lens whose inverse map does not evaluate on tensors (a
    # .lua drop-in that needs per-lane scalar control): it builds on the
    # exact float64 host builder only.  The JAX package's name.
    jittable: bool = True
    # resource-release hook (.lua lenses: unwinds coroutine threads a
    # script parked in its scalar interpreters, see lua_bridge.load_lua_lens).
    # Call only when discarding the LensDef for good; None for built-ins.
    release: Optional[Callable] = None


def resolve(name: str, spec: dict) -> LensDef:
    """Apply the loader's map-type resolution (``fisheye.c:1683-1731``):
    prefer inverse when both exist, honor an explicit ``map`` preference."""
    inverse = spec.get("lens_inverse")
    forward = spec.get("lens_forward")
    if inverse is not None:
        map_type = "inverse"
    elif forward is not None:
        map_type = "forward"
    else:
        raise ValueError(f"lens '{name}': no inverse or forward map provided")
    pref = spec.get("map")
    if pref is not None:
        if pref == "lens_inverse" and inverse is not None:
            map_type = "inverse"
        elif pref == "lens_forward" and forward is not None:
            map_type = "forward"
        else:
            raise ValueError(f"lens '{name}': unsupported map preference {pref!r}")
    return LensDef(
        name=name,
        forward=forward,
        inverse=inverse,
        map_type=map_type,
        width=float(spec.get("lens_width", 0) or 0),
        height=float(spec.get("lens_height", 0) or 0),
        max_fov=int(spec.get("max_fov", 0) or 0),
        max_vfov=int(spec.get("max_vfov", 0) or 0),
        onload=spec.get("onload"),
        jittable=bool(spec.get("jittable", True)),
        release=spec.get("release"),
    )


def make_context(globe) -> SimpleNamespace:
    """The host-provided symbols a lens script may use
    (``fisheye.c:254-260``): ``numplates``, ``latlon_to_ray``,
    ``ray_to_latlon`` and a vectorized ``plate_to_ray(i, u, v)`` bound to
    the current globe."""
    import numpy as np
    import torch

    from blinky_tpu_torch import geometry
    from blinky_tpu_torch import xmath as m

    def plate_to_ray(i, u, v):
        # CtoLUA_plate_to_ray (fisheye.c:1521-1538): goes through the
        # float32 plate_uv_to_ray, Lua receives the f32-valued components
        if m.xp(i, u, v) is torch:
            ref = next(t for t in (u, v, i) if isinstance(t, torch.Tensor))
            idx = torch.as_tensor(i, device=ref.device).long()
            fwd, rgt, up, dist = (
                torch.as_tensor(np.asarray(a, np.float32), device=ref.device)[idx]
                for a in (globe.forward, globe.right, globe.up, globe.dist))
            # the sqrt precision follows the input dtype, as in the builder
            f64 = torch.float64 if ref.dtype == torch.float64 else torch.float32
            return geometry.plate_uv_to_ray_c(u, v, fwd, rgt, up, dist, torch,
                                              torch.float32, f64)
        fwd = np.asarray(globe.forward)[i]
        rgt = np.asarray(globe.right)[i]
        up = np.asarray(globe.up)[i]
        dist = np.asarray(globe.dist)[i]
        # the sqrt precision follows the input dtype, as in the builder
        dt = getattr(u, "dtype", np.dtype(np.float64))
        f64 = np.float64 if dt == np.float64 else np.float32
        return geometry.plate_uv_to_ray_c(u, v, fwd, rgt, up, dist, np,
                                          np.float32, f64)

    return SimpleNamespace(
        numplates=globe.numplates,
        latlon_to_ray=geometry.latlon_to_ray,
        ray_to_latlon=geometry.ray_to_latlon,
        plate_to_ray=plate_to_ray,
    )


def names() -> list:
    """Built-in lens names (the ``f_lens <tab>`` completion set, reference
    ``fisheye.c:1106-1118``)."""
    return list(BUILTIN_LENSES)


def get(name: str, globe=None) -> LensDef:
    """Load a built-in lens for the given globe (re-evaluating metadata per
    globe, as the reference reloads the Lua script — ``fisheye.c:734-737``)."""
    if name not in BUILTIN_LENSES:
        raise KeyError(f"unknown lens '{name}' (have: {', '.join(BUILTIN_LENSES)})")
    mod = importlib.import_module(f"blinky_tpu_torch.lenses.{name}")
    ctx = make_context(globe) if globe is not None else None
    return resolve(name, mod.make(ctx))


def load_lens_module(path, globe=None) -> LensDef:
    """Load a user lens from a script: a Python module defining
    ``make(ctx)``, or a reference-format ``.lua`` script (``LUA_load_lens``,
    ``fisheye.c:1659-1750``, through :mod:`blinky_tpu_torch.lua_bridge`)."""
    path = Path(path)
    if path.suffix.lower() == ".lua":
        from blinky_tpu_torch.lua_bridge import load_lua_lens

        return load_lua_lens(path, globe)
    spec = importlib.util.spec_from_file_location(f"blinky_lens_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = make_context(globe) if globe is not None else None
    return resolve(path.stem, mod.make(ctx))
