"""Nothing the benchmark runs imports jax or the JAX package, and the
reference imports nothing of the program. Top-level names (before the
first dot) are compared whole: the program's name begins with the JAX
package's."""

import ast
import sys

import pytest

from benchmark import harness

JAX = {"jax", "jaxlib", "flax", "detjax"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(harness.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_module_imports_jax_or_detjax(path):
    assert not set(_imports(path)) & JAX


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert "detjax_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "statistics",
                         "typing", "numpy", "torch", "benchmark"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "detjax_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "detjax.ops", object())
    assert harness.forbidden_modules() == ["detjax"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    import shutil
    import subprocess

    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "r50_1024-train", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
