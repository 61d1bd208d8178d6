"""Every hand-written kernel launches on the card that holds its tensors.

The CUDA runtime launches into the current device's context and refuses a
stream of another device, and a launch's attributes (K3's shared-memory
limit, a block-stride grid's SM count) apply to the current device.  So
each wrapper allocates and launches inside ``kernels._build.on_device``,
which makes the tensors' card the current one and hands out its stream.
These tests run on the CPU: one reads the sources and finds every launch
of a C entry point (``lib.blinky_*``) inside that block; one checks what
the block enters and yields.  tests/test_torch_cuda.py launches each
kernel on the last card while card 0 is current, where there are two.
"""

import ast
import contextlib
from pathlib import Path

import pytest

from blinky_tpu_torch.kernels import _build

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "blinky_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _entry_point(call):
    """The C entry point that *call* launches, or None: an attribute call
    named ``blinky_*`` (not the error string), or ``_build.launch(wrapper,
    name, "blinky_*", ...)``."""
    if not isinstance(call, ast.Call) or not isinstance(call.func, ast.Attribute):
        return None
    name = call.func.attr
    if name == "launch" and len(call.args) >= 3 and isinstance(call.args[2], ast.Constant):
        name = call.args[2].value
    if isinstance(name, str) and name.startswith("blinky_") and name != "blinky_error_string":
        return name
    return None


def _launches(tree):
    """(call, the chain of its enclosing nodes) for every call of a C entry
    point (:func:`_entry_point`)."""
    found = []

    def walk(node, chain):
        if _entry_point(node):
            found.append((node, chain))
        for child in ast.iter_child_nodes(node):
            walk(child, chain + [node])

    walk(tree, [])
    return found


def _inside_on_device(chain):
    for node in chain:
        if isinstance(node, ast.With):
            for item in node.items:
                c = item.context_expr
                if (isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                        and c.func.attr == "on_device"):
                    return True
    return False


def test_every_launch_is_inside_on_device():
    launches, outside = 0, []
    for path in SOURCES:
        for call, chain in _launches(ast.parse(path.read_text())):
            launches += 1
            if not _inside_on_device(chain):
                outside.append(f"{path.relative_to(ROOT)}:{call.lineno} {_entry_point(call)}")
    assert not outside, outside
    # every entry point of the library is launched somewhere
    assert launches >= len(_build._SIGNATURES), launches


def test_no_stream_outside_the_helper():
    """The stream comes only from ``on_device``: the old ``stream()``
    helper, which read the current stream of a device that might not be
    the current one, is gone, and nothing reads a raw stream handle."""
    assert not hasattr(_build, "stream")
    for path in SOURCES:
        src = path.read_text()
        if path.name != "_build.py":
            assert ".cuda_stream" not in src, path


def test_on_device_enters_the_card_and_yields_its_stream(monkeypatch):
    import torch

    entered = []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append(("enter", dev))
        yield
        entered.append(("exit", dev))

    class Stream:
        cuda_stream = 0xBEEF

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: (entered.append(("stream", dev)), Stream())[1])
    dev = torch.device("cuda", 1)
    with _build.on_device(dev) as stream:
        assert stream == 0xBEEF
        assert entered == [("enter", dev), ("stream", dev)]
    assert entered[-1] == ("exit", dev)


@pytest.mark.parametrize("module", ["kernels/remap.py", "kernels/posed.py",
                                    "kernels/static_ray.py", "kernels/ingest.py",
                                    "lensmap/builder.py", "bench/sol.py"])
def test_each_wrapper_module_launches_through_the_helper(module):
    """The six modules that call ``_build.library()`` each launch, and each
    launch is inside the helper."""
    tree = ast.parse((ROOT / "blinky_tpu_torch" / module).read_text())
    found = _launches(tree)
    assert found and all(_inside_on_device(chain) for _, chain in found)
