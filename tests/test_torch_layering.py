"""The port's imports point one way: cli -> editing -> models -> ops ->
kernels. Two leaves are held here by reading their source with ``ast``
(every import, lazy ones inside functions included):

- ``tokenflow_torch/kernels/`` knows one device: none of its modules
  imports the layers above it or the frames group (``sharding``);
- ``tokenflow_torch/sharding/mesh.py`` imports no module of the port, so
  that every layer may import it.
"""

import ast
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parent.parent / "tokenflow_torch"

# package -> (its modules, the port's modules they must not import)
RULES = {
    "kernels": (sorted((PORT / "kernels").glob("*.py")),
                tuple(f"tokenflow_torch.{p}" for p in
                      ("ops", "models", "editing", "diffusion", "cli", "sharding"))),
    "sharding": ([PORT / "sharding" / "mesh.py"], ("tokenflow_torch",)),
}


def imported_modules(path: Path, root: Path = PORT.parent) -> set[str]:
    """The absolute names of the modules ``path`` imports anywhere in its
    body: ``from a import b`` names ``a`` and ``a.b`` (``b`` may be a
    module), and relative imports resolve against the file's package, which
    is its directory below ``root``."""
    package = ".".join(path.relative_to(root).with_suffix("").parts[:-1])
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = package.rsplit(".", node.level - 1)[0]
                base = f"{parent}.{base}" if base else parent
            names.add(base)
            names.update(f"{base}.{alias.name}" for alias in node.names)
    return names


def test_imported_modules_resolves_relative_and_lazy_imports(tmp_path):
    """The reader itself: lazy imports inside functions and relative
    imports are seen and named absolutely."""
    pkg = tmp_path / "tokenflow_torch" / "kernels"
    pkg.mkdir(parents=True)
    src = pkg / "probe.py"
    src.write_text("import torch\nfrom . import _build\n"
                   "def f():\n    from ..ops import attention\n")
    got = imported_modules(src, tmp_path)
    assert {"torch", "tokenflow_torch.kernels._build",
            "tokenflow_torch.ops.attention"} <= got


@pytest.mark.parametrize("package", sorted(RULES))
def test_package_imports_point_down(package):
    """No module of ``package`` imports a forbidden module of the port."""
    modules, forbidden = RULES[package]
    assert modules, f"no module found under tokenflow_torch/{package}"
    bad = {
        f"{path.relative_to(PORT.parent)} imports {name}"
        for path in modules
        for name in imported_modules(path)
        if any(name == f or name.startswith(f + ".") for f in forbidden)
    }
    assert not bad, sorted(bad)
