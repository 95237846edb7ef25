"""No module of the benchmark imports JAX, flax or the JAX package, and the
plain references import nothing of the program.  Top-level names are
compared whole: ``tpuvae_torch`` is the port, ``tpuvae`` the JAX package."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from portbench import harness

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tpuvae", "benchmarks"}


def _top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((PKG / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(PKG)))
def test_reference_imports_nothing_of_the_program(path):
    assert "tpuvae_torch" not in _top_names(path)


def test_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import tpuvae_torch.train\nfrom tpuvae_torch import ops\n")
    assert not _top_names(src) & FORBIDDEN
    src.write_text("from tpuvae.ops import stft\n")
    assert _top_names(src) & FORBIDDEN == {"tpuvae"}


def test_loaded_modules_are_compared_whole():
    assert harness.forbidden_modules(
        ["tpuvae_torch", "tpuvae_torch.train.loop", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["tpuvae.ops", "jax", "flax.linen", "torch"]) == [
            "flax.linen", "jax", "tpuvae.ops"]
