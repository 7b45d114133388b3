"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole, so ``repro_torch`` is not ``repro``); the
reference's side imports nothing of the port; nothing reads the
JAX package's benchmark folder."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
# the yardstick: the reference, the comparison, the draws, the counts
REFERENCE_SIDE = ("reference.py", "check.py", "weights.py", "work.py",
                  "traffic.py", "stats.py", "policy.py") \
    + tuple(str(f.relative_to(BENCH)) for f in
            sorted((BENCH / "families").glob("*.py")))


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_nor_the_jax_package(path):
    bad = {"jax", "jaxlib", "flax", "repro"} & set(_imports(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


@pytest.mark.parametrize("name", REFERENCE_SIDE)
def test_reference_side_imports_nothing_of_the_port(name):
    assert "repro_torch" not in set(_imports(BENCH / name))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_benchmarks(path):
    assert "benchmarks" not in set(_imports(path))
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks" + "/" not in node.value, path


def test_the_check_names_whole_top_level_names():
    from h100_bench.run import loaded_forbidden
    assert loaded_forbidden(["repro_torch", "repro_torch.models",
                             "jaxtyping", "numpy"]) == []
    assert loaded_forbidden(["repro.models", "jax._src"]) == ["jax",
                                                              "repro"]
