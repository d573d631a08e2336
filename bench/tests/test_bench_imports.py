"""Nothing under bench/ imports JAX or the JAX package, and nothing under
bench/reference imports the program: top-level module names compared
whole (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import ast

import pytest

from bench_cases import ROOT

BENCH = ROOT / "bench"
NO_JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & NO_JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "typing", "torch"}


def test_the_check_compares_whole_names():
    assert "repro_torch" not in NO_JAX
    assert top_level_imports(BENCH / "drivers" / "train.py") >= {
        "repro_torch"}
