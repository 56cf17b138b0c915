"""No JAX anywhere near a run; the reference imports nothing of the program."""

import ast
import sys
from pathlib import Path

from portbench import harness


def test_the_port_passes_and_the_jax_package_fails(monkeypatch):
    import avlen_tpu_torch  # noqa: F401

    assert "avlen_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "avlen_tpu", type(sys)("avlen_tpu"))
    assert harness.banned_modules() == ["avlen_tpu"]
    monkeypatch.delitem(sys.modules, "avlen_tpu")
    monkeypatch.setitem(sys.modules, "jax.numpy", type(sys)("jax.numpy"))
    assert harness.banned_modules() == ["jax"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_reference_imports_neither_the_port_nor_jax():
    for path in (harness.PORTBENCH / "reference").glob("*.py"):
        assert not set(_imports(path)) & {"avlen_tpu_torch", *harness.BANNED}, path


def test_no_benchmark_file_imports_jax():
    for path in harness.PORTBENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(harness.BANNED), path
