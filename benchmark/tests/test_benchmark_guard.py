"""The benchmark measures the PyTorch port alone: nothing it runs loads JAX
or the JAX package, the reference imports nothing of the program, and an
architecture module imports the program only inside the functions of its
program side."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import guard  # noqa: E402

PROGRAM = "tokenflow_torch"
# what may import the program: the system under test's loader, the stage
# drivers, the architectures' program side (lazily, below), and the tests
# that break it
PROGRAM_USERS = {"program.py", "drivers", "architectures", "tests"}
# the architecture modules: the benchmark's, and the tests' own
ARCHITECTURES = sorted(BENCH.glob("architectures/*.py")) + sorted(BENCH.glob("tests/*_arch.py"))


def test_forbidden_names_are_compared_whole():
    assert guard.loaded_forbidden({"tokenflow_torch", "tokenflow_torch.kernels",
                                   "jaxtyping", "flaxen", "tokenflow_tpux"}) == []
    assert guard.loaded_forbidden({"jax.numpy", "tokenflow_tpu.models.unet2d",
                                   "flax", "jaxlib.xla_client"}) == [
        "flax", "jax", "jaxlib", "tokenflow_tpu"]


def _imports(path: Path, top_level_only: bool = False) -> set[str]:
    names = set()
    tree = ast.parse(path.read_text())
    for node in tree.body if top_level_only else ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".", 1)[0] for n in names}


def test_reference_and_yardstick_import_nothing_of_the_program():
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(BENCH)
        tops = _imports(path)
        assert not tops & guard.FORBIDDEN, rel
        if rel.parts[0] == "reference":
            assert tops <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch",
                            "reference"}, (rel, tops)
        elif rel.parts[0] not in PROGRAM_USERS and rel.name not in PROGRAM_USERS:
            assert PROGRAM not in tops, rel


def test_architecture_modules_import_the_program_lazily():
    assert [p.name for p in ARCHITECTURES if p.parent.name == "architectures"]
    for path in ARCHITECTURES:
        assert PROGRAM not in _imports(path, top_level_only=True), path.relative_to(BENCH)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Import everything a run imports, the program's modules that the
    drivers call included, in a fresh process."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
import harness, manifest, program, tracing, readers, checks, inputs, weights, yardstick
from reference import model, steps, schedule, precision
for stage in ("edit", "invert"):
    manifest.driver(stage)
for arch in {[p.stem for p in sorted(BENCH.glob("architectures/*.py"))]!r}:
    manifest.architecture(arch)
for m in manifest.benchmark()["end_to_end"] + manifest.benchmark()["per_layer"]:
    manifest.reader(m["name"])
from tokenflow_torch.editing import pipeline
from tokenflow_torch.diffusion import inversion, ddim
from tokenflow_torch.cli.preprocess import build_eps_fn
from tokenflow_torch.models import unet2d, controlnet
from tokenflow_torch.kernels import _build
import guard
print(sorted({{m.split(".", 1)[0] for m in sys.modules}} & guard.FORBIDDEN))
guard.check("test")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_harness_refuses_to_run_without_the_cells_cuda_devices():
    """Here there is no card: the run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "sd21_pnp512_edit",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode != 0
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
