"""The port's trace replay and report against the JAX package's:
``traced_pipelined_sweep`` bitwise against the JAX replay and against the
port's own blocked executor, its spans and lane; ``Tracer.instant`` /
``Tracer.counter`` events; ``TraceCallback`` through ``Session`` (and a
fit with it bitwise equal to one without); ``launch.obs_report`` text
equal to the JAX package's on the same directories."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import ps as jps
from repro.launch import obs_report as jreport
from repro.obs import exec_trace as jtrace
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtr
from repro_torch import api
from repro_torch import obs
from repro_torch import ps as tps
from repro_torch import rng as trng
from repro_torch.convert import sampler_state_from_arrays
from repro_torch.data import corpus as corpus_mod
from repro_torch.launch import obs_report
from repro_torch.obs import exec_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import LANE_BASE, Tracer
from repro_torch.train import async_exec as texec

BLOCKS, STALENESS = 4, 1
PHASES = {"pull.inflight", "alias.build", "sample", "merge.store"}
ROUTES = {"dense": (None, None),
          "hybrid": (jps.HybridRoute(hot_words=40),
                     tps.HybridRoute(hot_words=40))}


@pytest.fixture(scope="module")
def carried():
    """(jax cfg, jax state, port state): tests/test_obs.py's replay size,
    80 docs, V = 128, K = 8, two cyclic shards."""
    from conftest import make_lda_state
    _, cfg, jst = make_lda_state(num_docs=80, vocab=128, k=8, num_shards=2,
                                 block_tokens=256)
    tst = sampler_state_from_arrays(
        *(np.asarray(x) for x in (jst.w, jst.d, jst.z, jst.valid,
                                  jst.doc_start, jst.doc_len, jst.nwk.value,
                                  jst.nk.value, jst.ndk)),
        dataclasses.asdict(cfg), device="cpu")
    return cfg, jst, tst


def _assert_same(a, b, what):
    """z, the physical n_wk, n_k and n_dk of two states equal bitwise (each
    a JAX or a port state)."""
    def arr(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    for name, get in (("z", lambda s: s.z), ("nwk", lambda s: s.nwk.value),
                      ("nk", lambda s: s.nk.value), ("ndk", lambda s: s.ndk)):
        np.testing.assert_array_equal(arr(get(a)), arr(get(b)),
                                      f"{what}: {name}")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replay_matches_jax_replay_and_the_executor(carried, route):
    cfg, jst, tst = carried
    jroute, troute = ROUTES[route]
    want = jtrace.traced_pipelined_sweep(jst, jax.random.PRNGKey(3), cfg,
                                         model_blocks=BLOCKS,
                                         staleness=STALENESS, route=jroute)
    before = (tst.z.clone(), tst.nwk.value.clone(), tst.nk.value.clone(),
              tst.ndk.clone())
    s = obs.ObsSession(obs.ObsConfig(enabled=True)).install()
    try:
        got = exec_trace.traced_pipelined_sweep(
            tst, trng.PRNGKey(3), cfg, model_blocks=BLOCKS,
            staleness=STALENESS, route=troute)
        events = s.tracer.events()
        groups = s.metrics.get("replay.groups").value
    finally:
        s.close(save=False)
    _assert_same(want, got, "JAX replay")
    step, info = texec.make_executor(
        tst, cfg, texec.ExecConfig(staleness=STALENESS, model_blocks=BLOCKS,
                                   route=troute))
    _assert_same(step.raw(tst, trng.PRNGKey(3)), got, "port executor")
    # the given state is not written into
    for a, b in zip(before, (tst.z, tst.nwk.value, tst.nk.value, tst.ndk)):
        assert torch.equal(a, b)

    spans = [e for e in events if e.get("ph") == "X"]
    assert PHASES <= {e["name"] for e in spans}
    n_groups = info["n_blocks"] // info["group"]
    assert groups == n_groups
    for name in PHASES - {"pull.inflight"}:
        assert sum(e["name"] == name for e in spans) == n_groups
    pulls = [e for e in spans if e["name"] == "pull.inflight"]
    assert len(pulls) == n_groups + 1            # the drain
    assert all(e["tid"] >= LANE_BASE for e in pulls)
    merges = [e for e in spans if e["name"] == "merge.store"]
    assert {e["args"]["route"] for e in merges} == {route}


def test_replay_without_a_session_runs_silently(carried):
    cfg, _, tst = carried
    assert obs.active() is None
    a = exec_trace.traced_pipelined_sweep(tst, trng.PRNGKey(5), cfg,
                                          model_blocks=BLOCKS,
                                          staleness=STALENESS)
    step, _ = texec.make_executor(
        tst, cfg, texec.ExecConfig(staleness=STALENESS, model_blocks=BLOCKS))
    _assert_same(step.raw(tst, trng.PRNGKey(5)), a, "untraced")


def _strip_ts(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def test_instant_and_counter_events_match_jax():
    jt, tt = jtr.Tracer(), Tracer()
    for tr in (jt, tt):
        tr.instant("fit.start", cat="session", mode="blocked", blocks=4)
        tr.instant("fit.end", cat="session")
        tr.counter("tokens_seen", tokens=4096)
        tr.counter("pair", a=1, b=2.5)
    assert _strip_ts(tt.events()) == _strip_ts(jt.events())
    kinds = [e["ph"] for e in tt.events()]
    assert kinds == ["M", "i", "i", "C", "C"]
    assert all(isinstance(e["ts"], float) for e in tt.events()[1:])


def _job(corp, **kw):
    kw = {"num_shards": 2, "eval_every": 0, **kw}
    return api.LDAJob(corpus=corp, num_topics=8, block_tokens=512, sweeps=3,
                      seed=0, **kw)


@pytest.fixture(scope="module")
def corp():
    return corpus_mod.generate_lda_corpus(seed=0, num_docs=120,
                                          mean_doc_len=40, vocab_size=300,
                                          num_topics=6)


@pytest.mark.parametrize("blocked", [False, True])
def test_trace_callback_owns_a_session_and_perturbs_nothing(tmp_path, corp,
                                                            blocked):
    extra = {"model_blocks": 4, "staleness": 1} if blocked else {}
    out = tmp_path / "cb_obs"
    cb = api.TraceCallback(api.ObsConfig(enabled=True, out_dir=str(out)))
    traced = api.Session(_job(corp, **extra), log_fn=lambda *a: None,
                         device="cpu").run(callbacks=[cb])
    assert obs.active() is None                    # closed after the fit
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events}
    # the callback's own events AND the executor's (ExecConfig.obs=None
    # inherits the callback-installed session)
    assert {"session.visit", "exec.sweep", "fit.start", "fit.end"} <= names
    visits = [e for e in events if e["name"] == "session.visit"]
    assert [e["args"]["step"] for e in visits] == [1, 2, 3]
    seen = [e["args"]["tokens"] for e in events if e["name"] == "tokens_seen"]
    assert seen == [corp.num_tokens * i for i in (1, 2, 3)]

    plain = api.Session(_job(corp, **extra), log_fn=lambda *a: None,
                        device="cpu").run()
    assert torch.equal(traced.nwk.to_dense(), plain.nwk.to_dense())
    assert torch.equal(traced.nk.value, plain.nk.value)
    assert torch.equal(traced.state.z, plain.state.z)


def test_trace_callback_adopts_an_installed_session(corp):
    with obs.session(obs.ObsConfig(enabled=True)) as s:
        api.Session(_job(corp), log_fn=lambda *a: None,
                    device="cpu").run(callbacks=[api.TraceCallback()])
        assert obs.active() is s
        names = [e["name"] for e in s.tracer.events()]
    assert names.count("session.visit") == 3
    assert names.count("fit.start") == names.count("fit.end") == 1


# -- obs_report: the inputs of tests/test_obs.py, and a port fit's dir -----

def _write_trace(path, events):
    with open(path / "trace.json", "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def _sections_dir(path, registry):
    _write_trace(path, [
        {"name": "exec.sweep", "cat": "exec", "ph": "X", "pid": 1,
         "tid": 0, "ts": 0.0, "dur": 9000.0,
         "args": {"overlap_pct": 80.0}},
        {"name": "exec.sweep", "cat": "exec", "ph": "X", "pid": 1,
         "tid": 0, "ts": 9000.0, "dur": 11000.0,
         "args": {"overlap_pct": 60.0}},
        {"name": "ps.push", "cat": "ps", "ph": "X", "pid": 1, "tid": 0,
         "ts": 0.0, "dur": 2000.0,
         "args": {"route": "hybrid", "batch": 100, "dense_rows": 4,
                  "dense_bytes": 128, "coo_cap": 200, "coo_bytes": 2400}},
    ])
    reg = registry()
    for v in (1.0, 2.0, 3.0, 50.0):
        reg.histogram("serve.request_ms").record(v)
    reg.counter("stream.prefetch_hit").inc(5)
    reg.save(str(path / "metrics.jsonl"))


def _tier_dir(path, registry):
    _write_trace(path, [
        {"name": "tier.miss_fetch", "cat": "ps", "ph": "X", "pid": 1,
         "tid": 0, "ts": 0.0, "dur": 1500.0,
         "args": {"rows": 32, "h2d_bytes": 8192}},
    ])
    reg = registry()
    reg.gauge("ps.tier.hit_rate").set(0.953)
    reg.gauge("ps.tier.hot_rows").set(2048)
    reg.gauge("ps.tier.device_bytes").set(262144)
    reg.gauge("ps.tier.evictions").set(7)
    reg.save(str(path / "metrics.jsonl"))


def _network_dir(path, registry):
    reg = registry()
    for op, n, bo, bi in (("pull_full", 10, 180, 4096000),
                          ("commit", 8, 512000, 160),
                          ("acquire", 12, 240, 600)):
        reg.counter(f"ps.rpc.calls.{op}").inc(n)
        reg.counter(f"ps.rpc.bytes_out.{op}").inc(bo)
        reg.counter(f"ps.rpc.bytes_in.{op}").inc(bi)
    reg.counter("ps.rpc.retries").inc(3)
    reg.counter("ps.rpc.reconnects").inc(2)
    for v in (0.5, 1.0, 8.0):
        reg.histogram("ps.rpc.ms.pull_full").record(v)
    reg.save(str(path / "metrics.jsonl"))
    reg2 = registry()
    reg2.counter("stream.prefetch_hit").inc(5)
    reg2.save(str(path / "m2.jsonl"))


def _admission_dir(path, registry):
    reg = registry()
    reg.counter("serve.batch_trigger.full").inc(6)
    reg.counter("serve.batch_trigger.timeout").inc(2)
    reg.counter("serve.shed").inc(3)
    reg.gauge("serve.version_lag").set(1)
    reg.gauge("serve.snapshot_version").set(9)
    reg.save(str(path / "metrics.jsonl"))
    reg2 = registry()
    reg2.counter("stream.prefetch_hit").inc(5)
    reg2.save(str(path / "m2.jsonl"))


def _empty_dir(path, registry):
    pass


DIRS = {"sections": _sections_dir, "tier": _tier_dir,
        "network": _network_dir, "admission": _admission_dir,
        "empty": _empty_dir}
REGISTRIES = {"port": MetricsRegistry, "jax": jmetrics.MetricsRegistry}
RENDER_ARGS = ({}, {"metrics_file": "m2.jsonl"},
               {"trace_file": "none.json", "metrics_file": "none"},
               {"top": 1})


@pytest.mark.parametrize("writer", sorted(REGISTRIES))
@pytest.mark.parametrize("kind", sorted(DIRS))
def test_obs_report_text_equals_jax(tmp_path, kind, writer):
    DIRS[kind](tmp_path, REGISTRIES[writer])
    for kw in RENDER_ARGS:
        assert obs_report.render(str(tmp_path), **kw) == \
            jreport.render(str(tmp_path), **kw), kw


def test_obs_report_sections(tmp_path):
    """tests/test_obs.py's checks of the report, on the port's renderer."""
    for kind in DIRS:
        (tmp_path / kind).mkdir()
        DIRS[kind](tmp_path / kind, MetricsRegistry)
    text = obs_report.render(str(tmp_path / "sections"))
    assert "exec.sweep" in text
    assert "mean=70.0%" in text                    # (80 + 60) / 2
    assert "hybrid" in text and "push routes" in text
    assert "serve.request_ms" in text
    assert "stream.prefetch_hit" in text
    assert "nothing recorded" in obs_report.render(str(tmp_path / "empty"))
    text = obs_report.render(str(tmp_path / "tier"))
    assert "tiered storage" in text
    assert "hit_rate=0.953" in text and "hot_rows=2048" in text
    assert "32 rows" in text and "8.0 KiB H2D" in text
    assert "tiered storage" not in obs_report.render(
        str(tmp_path / "tier"), trace_file="none.json", metrics_file="none")
    text = obs_report.render(str(tmp_path / "network"))
    assert "network (ps.rpc transport" in text
    assert text.index("acquire") < text.index("pull_full") < \
        text.index("commit")
    assert "retries=3" in text and "reconnects=2" in text
    assert "ps.rpc.ms.pull_full" in text
    assert "network (ps.rpc" not in obs_report.render(
        str(tmp_path / "network"), metrics_file="m2.jsonl")
    text = obs_report.render(str(tmp_path / "admission"))
    assert "serving admission" in text
    assert "full=6 (75%)" in text and "timeout=2 (25%)" in text
    assert "shed=3" in text and "version_lag=1" in text
    assert "serving_version=9" in text


def test_obs_report_of_a_tiered_port_fit_equals_jax(tmp_path, corp, capsys):
    out = tmp_path / "obs"
    api.APSLDA(_job(corp, storage="tiered", num_shards=1, hot_rows=64,
                    model_blocks=6, eval_every=1,
                    obs=api.ObsConfig(enabled=True, out_dir=str(out))),
               log_fn=lambda *a: None, device="cpu").fit()
    text = obs_report.render(str(out))
    assert text == jreport.render(str(out))
    for section in ("top spans", "async overlap", "tiered storage",
                    "latency histograms"):
        assert section in text, section
    obs_report.main([str(out), "--top", "5"])
    printed = capsys.readouterr().out
    assert printed.rstrip("\n") == obs_report.render(str(out), top=5)
