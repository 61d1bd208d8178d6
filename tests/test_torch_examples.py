"""The port's examples (blinky_tpu_torch/examples) against the JAX
package's (examples/), with tests/test_examples.py as the model: each
example runs at the JAX test's toy sizes, once from each package (the
port's with ``device="cpu"``), and writes the same files.

Tolerance 0 (byte-equal files) for every file that renders through the
exact float64 host lensmap, the equirect ingest or the float32 sweep, which
is every file but the posed frames of ``360_video``: ``render_posed`` of an
inverse lens takes the float32 lens stage on both sides (torch's against
XLA:CPU's), held to 0.02 of the pixels of the run, the rule of
tests/test_torch_posed.py for the two Sessions.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
POSED_SHARE = 0.02

SIZES = {
    "360_video": dict(W=64, H=48, S=32, N=6, BATCH=3),
    "pose_playback": dict(W=64, H=48, S=48, N=5),
    "pano_pan": dict(W=64, H=48, S=32, N=4, PANO_H=64, PANO_W=128),
    "equirect_pipeline": dict(W=64, H=48, PANO_W=128, PANO_H=64, S=48, N=4, BATCH=2),
    "lua_drop_in": dict(W=64, H=48, S=32, STEPS=3),
    "async_preview": dict(W=64, H=48, S=48, N=4),
}


def _load(path, name, sizes):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in sizes.items():
        assert hasattr(mod, k), k
        setattr(mod, k, v)
    return mod


@pytest.mark.parametrize("name", list(SIZES))
def test_example_equals_jax(tmp_path, name):
    jmod = _load(ROOT / "examples" / f"{name}.py", f"jax_example_{name}", SIZES[name])
    pmod = _load(ROOT / "blinky_tpu_torch" / "examples" / f"{name}.py",
                 f"torch_example_{name}", SIZES[name])
    assert pmod.DEVICE == "cuda"  # the card unless asked
    jmod.main(tmp_path / "j")
    pmod.main(tmp_path / "p", device="cpu")
    jfiles = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert jfiles == sorted(p.name for p in (tmp_path / "p").iterdir()) and jfiles
    differ = []
    for f in jfiles:
        a, b = (tmp_path / "j" / f).read_bytes(), (tmp_path / "p" / f).read_bytes()
        if a != b:
            differ.append(f)
    if name == "360_video":
        from blinky_tpu_torch.io.ppm import decode_ppm

        shots = [(decode_ppm((tmp_path / d / f).read_bytes()) for d in "jp")
                 for f in jfiles if f.endswith(".ppm")]
        mism = [(a != b).any(axis=-1).mean() for a, b in shots]
        share = float(np.mean(mism))
        print(f"360_video: {share:.4f} of the pixels differ from the JAX example's "
              f"(frames {differ})")
        assert share <= POSED_SHARE
        assert all(f.endswith(".ppm") for f in differ)
    else:
        assert differ == [], differ
    assert len(jfiles) == {"360_video": 7, "pose_playback": 5, "pano_pan": 4,
                      "equirect_pipeline": 5, "lua_drop_in": 2, "async_preview": 4}[name]


def test_examples_are_the_jax_set():
    """Every JAX example has its port, with the same name and ``main``."""
    jax_names = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    port = ROOT / "blinky_tpu_torch" / "examples"
    assert sorted(p.stem for p in port.glob("*.py") if p.stem != "__init__") == jax_names
    for n in jax_names:
        src = (port / f"{n}.py").read_text()
        assert "def main(" in src and "import jax" not in src and "blinky_tpu." not in src
