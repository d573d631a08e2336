"""The readers of the program's phase spans: on a small synthetic list
their values by hand, and on the spans of a CPU run of the tiny cell (put
under the card's ``cat``) the tiling of each sweep by its phases."""
from __future__ import annotations

import pytest

from bench_cases import run_tiny, tiny_cell
from bench import run, spans

PHASES = ("ps.pull", "kern.alias", "exec.gather", "kern.draws",
          "kern.sample", "exec.select", "kern.merge", "ps.store",
          "exec.write_z")
KERNELS = ("kern.alias", "kern.draws", "kern.sample", "kern.merge")


def _ev(name, ts, dur, cat="cuda", **args):
    e = {"name": name, "ph": "X", "cat": cat, "ts": float(ts),
         "dur": float(dur), "pid": 1, "tid": 1_000_000}
    if args:
        e["args"] = args
    return e


def _sweep(t0, prologue, phase_us, groups):
    """One sweep's spans: a prologue, then ``groups`` of (slots, tokens),
    each phase ``phase_us[name]`` long."""
    out, t = [_ev("exec.prologue", t0, prologue)], t0 + prologue
    for g, (slots, tokens) in enumerate(groups):
        g0 = t
        for name in PHASES:
            out.append(_ev(name, t, phase_us[name], group=g))
            t += phase_us[name]
        out.append(_ev("exec.group", g0, t - g0, group=g, slots=slots,
                       tokens=tokens))
    return [_ev("sweep.device", t0, t - t0)] + out


PHASE_US = {"ps.pull": 1, "kern.alias": 2, "exec.gather": 3, "kern.draws": 4,
            "kern.sample": 5, "exec.select": 6, "kern.merge": 7,
            "ps.store": 8, "exec.write_z": 9}


@pytest.fixture
def ctx():
    """Two sweeps of two groups (100 slots each; 90 + 10 tokens), a
    prologue of 10 us then 20 us; beside them host spans of the same names
    and a host-timed ``sweep.device``, which no reader may take."""
    evs = (_sweep(0, 10, PHASE_US, [(100, 90), (100, 10)])
           + _sweep(1000, 20, PHASE_US, [(100, 90), (100, 10)]))
    evs += [_ev(e["name"], e["ts"], e["dur"], cat="exec") for e in evs[:12]]
    evs.append(_ev("sweep.device", 0, 5000, cat="device"))
    return {"trace": None, "spans": evs, "sweeps": 2, "shape": {}}


def test_slot_efficiency(ctx):
    assert run.reader("train.slot_efficiency")(ctx) == pytest.approx(50.0)


def test_shares_and_sweep_ms(ctx):
    # a group is 45 us; the sweeps 10 + 90 and 20 + 90 us
    total = 100 + 110
    executor = 10 + 20 + 4 * (3 + 6 + 9)
    assert run.reader("train.executor_share")(ctx) == pytest.approx(
        100 * executor / total)
    assert run.reader("train.ps_share")(ctx) == pytest.approx(
        100 * 4 * (1 + 8) / total)
    assert run.reader("train.sweep_device_ms")(ctx) == pytest.approx(0.105)


def test_nothing_on_the_card_reads_nothing(ctx):
    host = dict(ctx, spans=[e for e in ctx["spans"] if e["cat"] != "cuda"])
    for name in ("train.slot_efficiency", "train.executor_share",
                 "train.ps_share", "train.sweep_device_ms"):
        assert run.reader(name)(host) is None


def test_the_programs_phases_tile_its_sweeps():
    """A CPU run's phases, timed on the host clock, read as the card's:
    every valid token in one group a sweep, and the executor's, the
    parameter server's and the kernels' phases add to the whole sweep."""
    out = run_tiny(tiny_cell(), seed=11, trace=True)
    c = out["ctx"]
    card = dict(c, spans=[dict(e, cat="cuda") if e.get("cat") == "cpu"
                          else e for e in c["spans"]])
    groups = spans.on_card(card, "exec.group")
    assert sum(e["args"]["tokens"] for e in groups) == (
        c["sweeps"] * c["shape"]["tokens"])
    assert len(spans.on_card(card, "sweep.device")) == c["sweeps"]
    parts = (run.reader("train.executor_share")(card)
             + run.reader("train.ps_share")(card)
             + spans.share(card, KERNELS))
    assert parts == pytest.approx(100.0, abs=1e-6)
    eff = run.reader("train.slot_efficiency")(card)
    assert 0 < eff <= 100
