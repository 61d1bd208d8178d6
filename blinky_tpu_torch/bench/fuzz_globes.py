"""Random and odd globes: plate layouts that no shipped globe has.

The shipped globes' frames are axis-aligned or symmetric (cube, trism,
tetra, fast).  Plate selection's ties and the bounds' edges show only on
other layouts, so the port's tests and ``chip_smoke.py`` also run these:

* :func:`random_plates`: a plausible random layout, drawn as the JAX
  package's fuzz test draws it (``tests/test_fuzz_parity.py::random_globe``,
  the same calls on the same generator): unit forwards off the axes, ups
  kept off their forwards (the loader orthogonalises them), fovs of 25-170
  degrees;
* :data:`ODD_PLATES`: one plate; two plates with one forward beside a third
  (every ray ties between the two, and the first must win); two opposite
  plates.

A layout is a list of ``(forward, up, fov_degrees)``, what
:func:`blinky_tpu_torch.globes.make_globe` takes.  :func:`write_globe`
writes one as a Python globe module for a Session's ``globe_dirs``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ODD_PLATES = {
    "one": [((0.3, -0.2, 0.93), (0.1, 1.0, 0.0), 100.0)],
    "tie": [((0.6, 0.0, 0.8), (0.0, 1.0, 0.0), 80.0),
            ((0.6, 0.0, 0.8), (0.3, 0.9, 0.1), 120.0),
            ((-0.5, 0.5, -0.7), (0.0, 0.0, 1.0), 150.0)],
    "opposite": [((0.2, 0.4, 0.9), (1.0, 0.0, 0.0), 160.0),
                 ((-0.2, -0.4, -0.9), (0.0, 1.0, 0.0), 160.0)],
}


def random_plates(rng, numplates) -> list:
    """*numplates* random ``(forward, up, fov_degrees)`` plates from the
    NumPy generator *rng*."""
    plates = []
    for _ in range(numplates):
        f = rng.normal(size=3)
        f /= np.linalg.norm(f)
        u = rng.normal(size=3)
        while abs(np.dot(u / np.linalg.norm(u), f)) > 0.95:
            u = rng.normal(size=3)
        plates.append((tuple(f), tuple(u), float(rng.uniform(25, 170))))
    return plates


def random_rubix_grid(rng) -> tuple:
    """A random ``(numcells, cell_size, pad_size)``, the fuzz test's ranges."""
    return int(rng.integers(2, 12)), float(rng.uniform(1, 6)), float(rng.uniform(0.3, 2))


def write_globe(directory, name, plates) -> Path:
    """Write *plates* as ``<name>.py`` into *directory* (made if missing);
    ``repr`` keeps every float exact.  Returns the file's path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    rows = ",\n".join(f"    ({tuple(map(float, f))!r}, {tuple(map(float, u))!r}, {float(fov)!r})"
                      for f, u, fov in plates)
    path = directory / f"{name}.py"
    path.write_text(f"plates = [\n{rows},\n]\n")
    return path
