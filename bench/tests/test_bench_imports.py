"""Nothing under bench/ imports JAX or the JAX package, and nothing under
bench/reference imports the program: top-level module names compared
whole (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import pytest

from bench_cases import ROOT
from spec_rules import REFERENCE_IMPORTS, imported

BENCH = ROOT / "bench"
NO_JAX = {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported(path) & NO_JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= REFERENCE_IMPORTS


def test_the_check_compares_whole_names():
    assert "repro_torch" not in NO_JAX
    assert imported(BENCH / "drivers" / "train.py") >= {
        "repro_torch"}
