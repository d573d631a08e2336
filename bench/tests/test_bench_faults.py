"""A run with the timed path broken underneath reads ``correct`` false,
once for each fault a training cell can have; so does the control, the
reference put in the program's place one precision below the
configuration's.  The harness's look for a card is skipped: the program
runs its plain CPU path at a tiny size."""
from __future__ import annotations

import pytest

from bench_cases import correct, run_tiny, tiny_cell
from bench.faults import train as faults


def test_start_fault_reads_incorrect(monkeypatch):
    monkeypatch.setattr(*faults.FAULTS["init_other_key"])
    out = run_tiny(tiny_cell(), seed=24)
    assert dict((n, v) for n, v, _ in out["checks"])["init_z"] > 0


def test_a_sound_run_is_correct():
    out = run_tiny(tiny_cell(), seed=21)
    assert correct(out), out["checks"]


@pytest.mark.parametrize("fault", [f for f in faults.FAULTS
                                   if f != "init_other_key"])
def test_fault_reads_incorrect(monkeypatch, fault):
    monkeypatch.setattr(*faults.FAULTS[fault])
    out = run_tiny(tiny_cell(), seed=22)
    assert not correct(out), out["checks"]


def test_control_in_bfloat16_reads_incorrect():
    """The reference in bfloat16 in the program's place, judged by the
    run's own check against the float32 reference from the same start."""
    cell = tiny_cell(vocab=1000, topics=64, docs=120)
    assert faults.CONTROL["float32"] == "bfloat16"
    out = run_tiny(cell, seed=23, control=faults.CONTROL["float32"])
    assert not correct(out), out["checks"]
    sound = run_tiny(cell, seed=23)
    assert correct(sound), sound["checks"]
