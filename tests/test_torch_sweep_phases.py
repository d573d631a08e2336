"""The pipelined sweep's phases under an obs session: on the ``[device]``
lane each group's phases tile its ``exec.group`` span in order, inside one
``sweep.device`` a sweep; a group's ``tokens`` and ``slots`` are its
valid slots in the index and its ``stride`` the index's capacity;
the swept state is bitwise the same with tracing on and off on both merge
branches; with no session nothing is marked; a live span is a profiler
range only while a profiler records; and CUDA events are read back onto
the host clock anchored at the wait (stand-in events on the CPU)."""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch import rng as trng
from repro_torch.api import LDAJob, Session
from repro_torch.data.corpus import synthetic_corpus
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import LANE_BASE, Tracer
from repro_torch.train import async_exec

sys.path.append(str(Path(__file__).resolve().parents[1]))
from chip_smoke import IdentityBackend  # noqa: E402

PHASES = ("ps.pull", "kern.alias", "exec.gather", "kern.draws",
          "kern.sample", "exec.select", "kern.merge", "ps.store",
          "exec.write_z")


@pytest.fixture(scope="module")
def made():
    """(state, step, info) of a blocked job: 4 blocks, staleness 1, so two
    groups of two blocks a sweep."""
    job = LDAJob(corpus=synthetic_corpus(80, 300, true_topics=5, seed=3),
                 num_topics=8, block_tokens=512, sweeps=1, eval_every=0,
                 model_blocks=4, staleness=1, seed=2)
    return Session(job, log_fn=lambda m: None, device="cpu").make_step()


def _routed(state):
    """The state on a backend that is not the in-process one: the routed
    merge."""
    client = state.nwk.client.with_backend(IdentityBackend())
    return state._replace(nwk=dataclasses.replace(state.nwk, client=client))


def _traced(step, state, key):
    s = obs.ObsSession(obs.ObsConfig(enabled=True, metrics=False)).install()
    try:
        out = step(state, key)
    finally:
        s.close(save=False)
    return out, s.tracer.events()


def _lane(events, name="device"):
    tid = next(e["tid"] for e in events if e.get("ph") == "M"
               and e["args"]["name"] == f"[{name}]")
    return sorted((e for e in events if e.get("ph") == "X"
                   and e["tid"] == tid), key=lambda e: (e["ts"], -e["dur"]))


def test_phases_tile_each_group_and_the_sweep(made):
    state, step, info = made
    out, events = _traced(step, state, trng.PRNGKey(4))
    lane = _lane(events)
    assert all(e["cat"] == "cpu" for e in lane)
    (sweep,) = [e for e in lane if e["name"] == "sweep.device"]
    groups = [e for e in lane if e["name"] == "exec.group"]
    n_groups = info["n_blocks"] // info["group"]
    assert [g["args"]["group"] for g in groups] == list(range(n_groups))
    (pro,) = [e for e in lane if e["name"] == "exec.prologue"]
    assert pro["ts"] == sweep["ts"]
    assert pro["ts"] + pro["dur"] == pytest.approx(groups[0]["ts"])
    end = sweep["ts"] + sweep["dur"]
    for a, b in zip(groups, groups[1:]):
        assert a["ts"] + a["dur"] == pytest.approx(b["ts"])
    assert groups[-1]["ts"] + groups[-1]["dur"] == pytest.approx(end)
    for g in groups:
        grp = g["args"]["group"]
        phases = [e for e in lane if e["name"] in PHASES
                  and e["args"]["group"] == grp]
        assert tuple(e["name"] for e in phases) == PHASES
        assert phases[0]["ts"] == g["ts"]
        for a, b in zip(phases, phases[1:]):
            assert a["ts"] + a["dur"] == pytest.approx(b["ts"])
        assert phases[-1]["ts"] + phases[-1]["dur"] == pytest.approx(
            g["ts"] + g["dur"])
    # the host side: live spans of the same names on the calling thread
    host = [e for e in events if e.get("ph") == "X" and e["tid"] < LANE_BASE]
    names = [e["name"] for e in host]
    for name in PHASES:
        assert names.count(name) == n_groups, name
    for name in ("exec.prologue", "exec.wait", "exec.dispatch",
                 "exec.sweep"):
        assert names.count(name) == 1, name
    assert names.count("exec.group") == n_groups
    spans = {e["name"]: e for e in host}
    wait, disp, whole = (spans[n] for n in ("exec.wait", "exec.dispatch",
                                            "exec.sweep"))
    assert disp["ts"] == whole["ts"]
    assert disp["ts"] + disp["dur"] <= wait["ts"]
    assert wait["ts"] + wait["dur"] <= whole["ts"] + whole["dur"]


def test_groups_carry_the_index_counts(made):
    state, step, info = made
    _, events = _traced(step, state, trng.PRNGKey(5))
    groups = [e for e in _lane(events) if e["name"] == "exec.group"]
    # the executor's index is at merge-unit granularity: a row a group
    idx, _, counts, _ = async_exec.blocked_index(
        state, info["n_blocks"], info["staleness"])
    assert [e["args"]["tokens"] for e in groups] == counts
    assert sum(counts) == int(state.valid.sum())
    # a group works its valid slots alone; its counters keep the row's
    # capacity as their stride
    assert [e["args"]["slots"] for e in groups] == counts
    assert {e["args"]["stride"] for e in groups} == {idx.shape[1]}


@pytest.mark.parametrize("routed", [False, True], ids=["one_launch",
                                                       "routed"])
def test_tracing_perturbs_nothing(made, routed):
    state, step, _ = made
    st = _routed(state) if routed else state
    assert async_exec.merges_in_one_launch(st.nwk) is not routed
    plain = step(st, trng.PRNGKey(6))
    traced, events = _traced(step, st, trng.PRNGKey(6))
    assert any(e.get("name") == "kern.merge" for e in events)
    for a, b in ((plain.z, traced.z), (plain.nwk.value, traced.nwk.value),
                 (plain.nk.value, traced.nk.value), (plain.ndk, traced.ndk)):
        assert torch.equal(a, b)


def test_no_session_marks_nothing(made, monkeypatch):
    state, step, _ = made

    def refuse(*a, **k):
        raise AssertionError("marked without a session")

    monkeypatch.setattr(Tracer, "device_timeline", refuse)
    monkeypatch.setattr(obs_trace, "DeviceTimeline", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert obs.active() is None
    assert async_exec.sweep_phases(state.z.device) is async_exec._NO_PHASES
    step(state, trng.PRNGKey(7))


def test_no_profiler_no_range(made, monkeypatch):
    state, step, _ = made

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, events = _traced(step, state, trng.PRNGKey(8))
    assert any(e.get("name") == "exec.wait" for e in events)


def test_live_spans_are_profiler_annotations(made, tmp_path):
    state, step, _ = made
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _, events = _traced(step, state, trng.PRNGKey(9))
        with obs.session(obs.ObsConfig(enabled=True, metrics=False,
                                       out_dir=str(tmp_path / "o"))):
            with obs.span("a.live.span"):
                pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    got = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation"]
    for name in ("a.live.span", "exec.wait", "exec.prologue", "exec.group")\
            + PHASES:
        assert name in got, name
    # spans recorded after the fact are not ranges
    assert "exec.dispatch" not in got and "sweep.device" not in got


class _Clock:
    """Stand-ins for CUDA events on a device clock the test advances."""

    def __init__(self):
        self.now_ms = 0.0
        self.synced = 0
        clock = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                self.at = None

            def record(self, stream=None):
                self.at = clock.now_ms

            def elapsed_time(self, other):
                return other.at - self.at

            def synchronize(self):
                clock.synced += 1

        self.Event = Event


def test_events_are_anchored_at_the_wait(monkeypatch):
    """A span's end is the wait's time less the device time from its event
    to the last one; reading them waits for nothing, unless at a close."""
    clock = _Clock()
    monkeypatch.setattr(torch.cuda, "Event", clock.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")
    tr = Tracer()
    tl = tr.device_timeline(torch.device("cuda", 0))
    for name, grp, ms in (("exec.prologue", -1, 0.0), ("ps.pull", 0, 1.0),
                          ("kern.draws", 0, 3.0)):
        clock.now_ms = ms
        tl.mark(name, grp, {"slots": 8, "tokens": 5} if grp == 0 else None)
    clock.now_ms = 7.0
    tl.end()
    t_wait = tr._epoch_ns + 100_000_000           # 100 ms after the epoch
    tr.flush_device()
    assert not [e for e in tr.events() if e.get("ph") == "X"]
    tr.device_waited(t_wait)
    tr.flush_device()
    assert clock.synced == 0
    got = {e["name"]: (e["ts"], e["dur"], e.get("args"), e["cat"])
           for e in tr.events() if e.get("ph") == "X"}
    us = 100_000.0                                # the wait, in us
    assert got["sweep.device"][:2] == (us - 7000.0, 7000.0)
    assert got["exec.prologue"][:2] == (us - 7000.0, 1000.0)
    assert got["ps.pull"][:3] == (us - 6000.0, 2000.0, {"group": 0})
    assert got["kern.draws"][:2] == (us - 4000.0, 4000.0)
    assert got["exec.group"][:3] == (us - 6000.0, 6000.0,
                                     {"slots": 8, "tokens": 5, "group": 0})
    assert {v[3] for v in got.values()} == {"cuda"}
    # a timeline not yet read at a session's close waits for its last event
    tr2 = Tracer()
    tl2 = tr2.device_timeline(torch.device("cuda", 0))
    tl2.mark("exec.prologue")
    tl2.end()
    tr2.flush_device(wait=True)
    assert clock.synced == 1
    assert [e["name"] for e in tr2.events() if e.get("ph") == "X"] == [
        "sweep.device", "exec.prologue"]
