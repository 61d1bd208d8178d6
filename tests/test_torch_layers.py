"""The port's package graph points one way: leaf modules -> kernels/ ->
parallel/ -> api.py -> cli.py, with bench/ a tool beside cli.py.

Every ``.py`` under blinky_tpu_torch/ is parsed (no module is imported),
and every import in it is read, those inside functions included, since a
function-level import is how a cycle hides.
"""

import ast
from pathlib import Path

import pytest

PKG = "blinky_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent / PKG


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imported(path: Path) -> set:
    """The dotted names *path* imports: for ``from X import a`` both X and
    X.a (a may be a submodule), relative imports resolved."""
    mod = _module_name(path)
    package = mod if path.name == "__init__.py" else mod.rpartition(".")[0]
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            src = node.module
            if node.level:
                base = package.split(".")
                base = base[:len(base) - node.level + 1]
                src = ".".join(base + ([src] if src else []))
            names.add(src)
            names.update(f"{src}.{a.name}" for a in node.names)
    return names


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def _offenders(importer_ok, target: str) -> list:
    out = []
    for path in sorted(ROOT.rglob("*.py")):
        rel = path.relative_to(ROOT).as_posix()
        if importer_ok(rel):
            continue
        hits = sorted(n for n in _imported(path) if _under(n, target))
        if hits:
            out.append(f"{rel}: {', '.join(hits)}")
    return out


RULES = {
    # only bench/ and cli.py import bench: the suite is a tool beside the
    # CLI, and the program never needs it
    "bench_beside_cli": (
        lambda rel: rel.startswith("bench/") or rel == "cli.py", f"{PKG}.bench"),
    # kernels/ imports no parallel: the mesh copies kernels per device, and
    # a kernel knows nothing of meshes
    "kernels_below_parallel": (
        lambda rel: not rel.startswith("kernels/"), f"{PKG}.parallel"),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_imports_point_one_way(rule):
    importer_ok, target = RULES[rule]
    assert _offenders(importer_ok, target) == []

