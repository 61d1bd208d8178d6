"""Globes: multi-camera plate layouts covering the view sphere.

A globe is what the reference loads from ``game/lua-scripts/globes/*.lua``
(loader: ``LUA_load_globe``, ``engine/NQ/fisheye.c:1752-1875``): an ordered
list of up to ``MAX_PLATES = 6`` pinhole cameras, each ``(forward, up,
fov_degrees)`` in the player's camera frame, plus an optional
``globe_plate(x, y, z) -> index | None`` resolver override
(``fisheye.c:2027-2033``; used by ``globes/fast.lua``).

The loader semantics reproduced here:
* ``right = up x forward``, then ``up = forward x right``
  (``fisheye.c:1849-1850``) — re-orthogonalization without normalization;
* ``fov`` converted to radians, must be ``> 0`` (``fisheye.c:1858-1865``);
* ``dist = 0.5 / tan(fov/2)`` (``fisheye.c:1868``);
* forward vectors are **not** normalized — plate selection dots against
  them as given (matters for ``tetra``'s computed vectors).

User globes are Python modules defining the names the Lua contract uses
(``plates``, optional ``globe_plate``) or the reference's ``.lua`` scripts;
see :func:`load_globe_module`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from blinky_tpu_torch import geometry
from blinky_tpu_torch.palette import MAX_PLATES


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: ndarray fields
class Globe:
    """A validated globe: derived plate frames in **float32** NumPy arrays,
    matching the reference's ``vec_t`` plate storage (``fisheye.c:354-358``)
    — the mixed float32/double precision boundary is part of the contract
    (see geometry.py's C-emulation section)."""

    name: str
    forward: np.ndarray  # [n, 3] f32 as given by the script (not normalized)
    right: np.ndarray  # [n, 3] f32 = up x forward
    up: np.ndarray  # [n, 3] f32 = forward x right
    fov_rad: np.ndarray  # [n] f32 (vec_t fov, fisheye.c:357)
    dist: np.ndarray  # [n] f32 = 0.5 / tan(fov/2) (fisheye.c:1868)
    # Optional vectorized resolver (x, y, z, globe) -> plate index, -1 = none.
    plate_resolver: Optional[Callable] = None
    # False when the resolver does not evaluate on tensors (a scalar-only
    # .lua globe_plate): device builds route to the exact host path, like
    # LensDef.jittable does for lenses (the JAX package's name)
    jittable: bool = True

    @property
    def numplates(self) -> int:
        return int(self.forward.shape[0])


def make_globe(
    name: str,
    plates: Sequence,
    plate_resolver: Optional[Callable] = None,
    jittable: bool = True,
) -> Globe:
    """Validate and derive a :class:`Globe` from ``(forward, up, fov_deg)``
    triples, mirroring ``LUA_load_globe`` (``fisheye.c:1784-1875``)."""
    if not 1 <= len(plates) <= MAX_PLATES:
        raise ValueError(f"globe '{name}': need 1..{MAX_PLATES} plates, got {len(plates)}")
    fwd = np.array([p[0] for p in plates], dtype=np.float64)
    up_in = np.array([p[1] for p in plates], dtype=np.float64)
    fov_deg = np.array([p[2] for p in plates], dtype=np.float64)
    if fwd.shape != (len(plates), 3) or up_in.shape != (len(plates), 3):
        raise ValueError(f"globe '{name}': forward/up must be 3-vectors")
    if np.any(fov_deg <= 0):
        raise ValueError(f"globe '{name}': plate fov must be > 0")
    forward, right, up = geometry.plate_frames(fwd, up_in)  # f32, f32 math
    # fov computed in double, stored vec_t (fisheye.c:1858); dist computed
    # in double FROM the f32-stored fov, stored vec_t (fisheye.c:1868).
    fov_rad = (fov_deg * np.pi / 180.0).astype(np.float32)
    dist = geometry.plate_dist(fov_rad.astype(np.float64)).astype(np.float32)
    return Globe(
        name=name,
        forward=forward,
        right=right,
        up=up,
        fov_rad=fov_rad,
        dist=dist,
        plate_resolver=plate_resolver,
        jittable=jittable,
    )


_REGISTRY: dict = {}


def register(name: str, factory: Callable[[], Globe]) -> None:
    _REGISTRY[name] = factory


def names() -> list:
    """Sorted built-in globe names (the ``f_globe <tab>`` completion set,
    reference ``fisheye.c:1164-1176``)."""
    return sorted(_REGISTRY)


def get(name: str) -> Globe:
    if name in _REGISTRY:
        return _REGISTRY[name]()
    raise KeyError(f"unknown globe '{name}' (have: {', '.join(names())})")


def load_globe_module(path) -> Globe:
    """Load a user globe from a script: a Python module defining ``plates``
    (list of ``(forward, up, fov_deg)``) and optionally ``globe_plate``, or
    a reference-format ``.lua`` script (``LUA_load_globe``,
    ``fisheye.c:1752-1875``, through :mod:`blinky_tpu_torch.lua_bridge`)."""
    path = Path(path)
    if path.suffix.lower() == ".lua":
        from blinky_tpu_torch.lua_bridge import load_lua_globe

        return load_lua_globe(path)
    spec = importlib.util.spec_from_file_location(f"blinky_globe_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "plates"):
        raise ValueError(f"globe script {path} must define 'plates'")
    return make_globe(path.stem, mod.plates, getattr(mod, "globe_plate", None))


from blinky_tpu_torch.globes import builtin as _builtin  # noqa: E402  (registers built-ins)
