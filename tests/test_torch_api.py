"""The port's estimator API against the JAX package's: a whole
``APSLDA(job).fit()`` on the CPU gives the JAX package's count tables
bitwise and its perplexities within rtol 1e-5; jobs validate alike;
``Session`` refuses the plane the port does not have yet (SPMD) and runs
the network PS; callbacks,
tracing and publishing observe without perturbing."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro.data.corpus import synthetic_corpus as jcorpus
from repro_torch import api as tapi
from repro_torch.data.corpus import synthetic_corpus as tcorpus
from repro_torch.infer.snapshot import SnapshotPublisher

QUIET = dict(log_fn=lambda m: None)


@pytest.fixture(scope="module")
def corpora():
    args = (70, 250)
    kw = dict(true_topics=6, seed=5)
    return jcorpus(*args, **kw), tcorpus(*args, **kw)


def _jobs(corpora, **kw):
    jc, tc = corpora
    base = dict(num_topics=8, block_tokens=512, sweeps=3, eval_every=1,
                seed=3)
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    route = kw.get("route")
    if route is not None:
        tkw["route"] = (tapi.HybridRoute(hot_words=route.hot_words)
                        if hasattr(route, "hot_words") else tapi.CooRoute())
    return japi.LDAJob(corpus=jc, **jkw), tapi.LDAJob(corpus=tc, **tkw)


FITS = [
    dict(route=japi.HybridRoute(hot_words=25)),
    dict(route=japi.CooRoute(), staleness=1),
    dict(model_blocks=5, staleness=0, hot_words=25),
    dict(model_blocks=4, staleness=1, route=japi.HybridRoute(hot_words=25),
         num_shards=2),
]


@pytest.mark.parametrize("kw", FITS, ids=["hybrid", "coo-s1", "blocked",
                                          "blocked-s1-shards2"])
def test_fit_matches_jax(corpora, kw):
    jjob, tjob = _jobs(corpora, **kw)
    jm = japi.APSLDA(jjob, **QUIET).fit()
    est = tapi.APSLDA(tjob, device="cpu", **QUIET)
    tm = est.fit()
    np.testing.assert_array_equal(tm.nwk, np.asarray(jm.nwk))
    np.testing.assert_array_equal(tm.nk, np.asarray(jm.nk))
    jp = [r["perplexity"] for r in jm.history]
    tp = [r["perplexity"] for r in tm.history]
    np.testing.assert_allclose(tp, jp, rtol=1e-5)
    assert len(tp) == 3 and tp[-1] < tp[0]
    assert tm.info["mode"] == ("blocked" if kw.get("model_blocks")
                               else "snapshot")
    assert est.result_.state.z.device.type == "cpu"


def test_fit_from_docs_matches_jax(corpora):
    jc, _ = corpora
    docs = [jc.w[s:s + n] for s, n in zip(jc.doc_start, jc.doc_len)]
    jm = japi.APSLDA(japi.LDAJob(docs=docs, num_topics=6, block_tokens=512,
                                 sweeps=2, eval_every=0), **QUIET).fit()
    tm = tapi.APSLDA(tapi.LDAJob(docs=docs, num_topics=6, block_tokens=512,
                                 sweeps=2, eval_every=0), device="cpu",
                     **QUIET).fit()
    np.testing.assert_array_equal(tm.nwk, np.asarray(jm.nwk))
    assert tm.history == [] and jm.history == []


def test_job_fields_are_the_jax_packages(corpora):
    jf = {f.name for f in dataclasses.fields(japi.LDAJob)}
    tf = {f.name for f in dataclasses.fields(tapi.LDAJob)}
    assert jf - tf == {"use_kernels", "kernel_interpret"}
    assert tf <= jf


@pytest.mark.parametrize("bad", [dict(sweeps=0), dict(num_topics=0),
                                 dict(hot_words=3,
                                      route=tapi.HybridRoute()),
                                 dict(staleness=-1), dict(alpha=0.0)])
def test_job_validation_matches_jax(corpora, bad):
    jbad = dict(bad)
    if "route" in jbad:
        jbad["route"] = japi.HybridRoute()
    with pytest.raises(japi.JobValidationError) as je:
        japi.LDAJob(corpus=corpora[0], **jbad).validate()
    with pytest.raises(tapi.JobValidationError) as te:
        tapi.LDAJob(corpus=corpora[1], **bad).validate()
    assert te.value.problems == je.value.problems


@pytest.mark.parametrize("plane,item", [
    (dict(backend="spmd"), "SPMD"),
    (dict(backend="net", workers=1), "Network parameter server"),
    (dict(storage="tiered", model_blocks=4), "Tiered storage"),
    (dict(route="auto"), "Autotuner"),
    (dict(staleness="auto"), "Autotuner"),
])
def test_session_refuses_unported_planes(corpora, tmp_path, plane, item):
    """Every plane is ported, and ``unported_planes`` names none.  SPMD
    runs on 4 gloo rank processes (mesh 2 x 2): its counts are the
    histogram of the whole mesh's assignments, the token mass is the
    corpus's, and its perplexity falls.  Tiered storage, the autotuner
    and the network PS run on the CPU and give the JAX package's counts
    bitwise (for "auto", the JAX fit run with the plan the port chose; for
    the net plane, one worker, whose lease order is deterministic, and
    the final perplexity, read once every commit has landed).  A net job
    with two workers conserves counts: the server's tables are the
    histogram of the persisted assignments."""
    job = tapi.LDAJob(corpus=corpora[1], **plane)
    assert tapi.session.unported_planes(job) == []
    if item == "SPMD":
        from repro_torch.core import lightlda as tlda
        est = tapi.APSLDA(dataclasses.replace(
            job, num_topics=8, sweeps=2, eval_every=1, block_tokens=512,
            seed=3), device="cpu", devices=4, **QUIET)
        m = est.fit()
        st = est.result_.state
        nwk, nk, _ = tlda.rebuild_counts(st.w, st.d, st.z, st.valid,
                                         st.ndk.shape[0], m.cfg)
        np.testing.assert_array_equal(m.nwk, nwk.to_dense().numpy())
        np.testing.assert_array_equal(m.nk, nk.value.numpy())
        assert int(m.nk.sum()) == corpora[1].num_tokens
        ppl = [r["perplexity"] for r in m.history]
        assert len(ppl) == 2 and ppl[1] < ppl[0]
        assert m.info["mesh_data"] == m.info["mesh_model"] == 2
        return
    def tier_dir(name):
        return ({"tier_dir": str(tmp_path / name)} if "storage" in plane
                else {})

    job = dataclasses.replace(job, num_topics=8, sweeps=2, eval_every=1,
                              block_tokens=512, seed=3, **tier_dir("t"))
    tm = tapi.APSLDA(job, device="cpu", **QUIET).fit()
    jkw = dict(plane, num_topics=8, sweeps=2, eval_every=1, block_tokens=512,
               seed=3, **tier_dir("j"))
    tuned = tm.info.get("autotune")
    if tuned is not None:
        chosen = tuned["chosen"]
        jkw["route"] = (japi.HybridRoute(hot_words=chosen["hot_words"])
                        if chosen["hot_words"] is not None else
                        {"dense": japi.DenseRoute(),
                         "coo": japi.CooRoute()}[chosen["route"]])
        jkw["staleness"] = chosen["staleness"]
    jm = japi.APSLDA(japi.LDAJob(corpus=corpora[0], **jkw), **QUIET).fit()
    np.testing.assert_array_equal(tm.nwk, np.asarray(jm.nwk))
    np.testing.assert_array_equal(tm.nk, np.asarray(jm.nk))
    tp = [r["perplexity"] for r in tm.history]
    jp = [r["perplexity"] for r in jm.history]
    if item != "Network parameter server":
        np.testing.assert_allclose(tp, jp, rtol=1e-5)
        return
    # net: rows before the last read counts that later commits may move
    assert len(tp) == len(jp) == tm.info["total_visits"]
    np.testing.assert_allclose(tp[-1], jp[-1], rtol=1e-5)
    assert tm.info["worker_stats"][0]["device"] == "cpu"
    est = tapi.APSLDA(dataclasses.replace(job, workers=2), device="cpu",
                      **QUIET)
    m2 = est.fit()
    from repro_torch.data import stream as tstream
    rw, rk = tstream.rebuild_counts_from_stream(est.result_.reader, 8)
    np.testing.assert_array_equal(m2.nwk, rw)
    np.testing.assert_array_equal(m2.nk, rk)
    assert int(m2.nk.sum()) == corpora[1].num_tokens
    assert sum(s["visits"] for s in m2.info["worker_stats"]) \
        == m2.info["total_visits"]


def test_session_refuses_a_streamed_source(tmp_path):
    """Streamed sources run on the stream plane; a directory that holds no
    stream manifest is refused before any device work."""
    job = tapi.LDAJob(stream_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no stream manifest"):
        tapi.Session(job, device="cpu").run()


def test_checkpointed_fit_writes_the_jax_file(corpora, tmp_path):
    """A memory job's checkpoint policy writes ``save_lda``'s file at the
    end of the fit: byte-equal to the JAX package's, and the counts it
    restores are the fit's."""
    from repro_torch.train import checkpoint as tckpt
    paths = [str(tmp_path / f"{p}.npz") for p in ("jax", "torch")]
    jjob, tjob = _jobs(corpora, sweeps=2, eval_every=0)
    japi.APSLDA(dataclasses.replace(
        jjob, checkpoint=japi.CheckpointPolicy(path=paths[0], every=1)),
        **QUIET).fit()
    tm = tapi.APSLDA(dataclasses.replace(
        tjob, checkpoint=tapi.CheckpointPolicy(path=paths[1], every=1)),
        device="cpu", **QUIET).fit()
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    st = tckpt.restore_lda(paths[1], tm.cfg, corpora[1].num_docs,
                           device="cpu")
    np.testing.assert_array_equal(st.nwk.to_dense().numpy(), tm.nwk)


def test_estimator_defaults_to_the_card(corpora):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    job = tapi.LDAJob(corpus=corpora[1], sweeps=1, eval_every=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.APSLDA(job, **QUIET).fit()


def test_callbacks_and_tracing_do_not_perturb(corpora, tmp_path):
    _, tc = corpora
    from repro_torch.data.corpus import train_heldout_split
    train, held = train_heldout_split(tc, 0.2)
    base = dict(corpus=train, num_topics=8, block_tokens=512, sweeps=2,
                eval_every=1, seed=1, model_blocks=3, staleness=1)
    plain = tapi.APSLDA(tapi.LDAJob(**base), device="cpu", **QUIET).fit()
    ev = tapi.EvalCallback(every=1, heldout=held, coherence=True)
    log_path = tmp_path / "log.jsonl"
    obs = tapi.ObsConfig(enabled=True, out_dir=str(tmp_path / "obs"))
    traced = tapi.APSLDA(tapi.LDAJob(**base, obs=obs), device="cpu",
                         **QUIET).fit(callbacks=[ev, tapi.LogCallback(
                             str(log_path))])
    np.testing.assert_array_equal(traced.nwk, plain.nwk)
    np.testing.assert_array_equal(traced.nk, plain.nk)
    assert [r["perplexity"] for r in traced.history] == [
        r["perplexity"] for r in plain.history]
    assert len(ev.history) == 2
    for row in ev.history:
        assert np.isfinite(row["heldout_perplexity"])
    # coherence is the JAX package's NPMI on the same φ (NaN where a pair
    # co-occurs in every held-out document, as there)
    from repro.core import coherence as jcoh
    from repro_torch.core import perplexity as tppl
    phi = tppl.phi_from_counts(torch.from_numpy(traced.nwk).float(),
                               torch.from_numpy(traced.nk).float(),
                               0.01).numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        want = jcoh.mean_coherence(phi, held.w, held.d, phi.shape[0],
                                   held.num_docs)
    np.testing.assert_equal(ev.history[-1]["coherence"], want)
    events = [json.loads(line)["event"]
              for line in log_path.read_text().splitlines()]
    assert events == ["fit_start", "sweep", "sweep", "fit_end"]
    trace = json.loads((tmp_path / "obs" / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    for span in ("exec.sweep", "exec.dispatch", "sweep.device",
                 "session.step", "session.setup"):
        assert names.count(span) >= 1, span
    lanes = [e for e in trace["traceEvents"] if e.get("ph") == "M"
             and e["args"]["name"] == "[device]"]
    assert len(lanes) == 1
    device = [e for e in trace["traceEvents"]
              if e.get("name") == "sweep.device"]
    assert all(e["tid"] == lanes[0]["tid"] for e in device)
    metrics = [json.loads(line)["name"] for line in
               (tmp_path / "obs" / "metrics.jsonl").read_text().splitlines()]
    assert {"exec.sweep_ms", "exec.overlap_pct"} <= set(metrics)


def test_publish_state_and_make_step(corpora):
    _, tc = corpora
    job = tapi.LDAJob(corpus=tc, num_topics=8, block_tokens=512, sweeps=1,
                      eval_every=0)
    session = tapi.Session(job, device="cpu", **QUIET)
    state, step, info = session.make_step()
    assert info["mode"] == "snapshot" and callable(step.raw)
    state = step(state, torch.tensor([0, 9]))
    pub = SnapshotPublisher(session.cfg)
    snap = pub.publish_state(state)
    model = tapi.TopicModel(state.nwk.to_dense(), state.nk.value,
                            session.cfg, device="cpu")
    assert snap.version == 1 and pub.version == 1
    assert torch.equal(snap.phi, model.snapshot.phi)
    assert torch.equal(snap.model.aprob, model.snapshot.model.aprob)


def test_trained_model_serves(corpora):
    _, tc = corpora
    job = tapi.LDAJob(corpus=tc, num_topics=8, block_tokens=512, sweeps=2,
                      eval_every=0, route=tapi.HybridRoute(hot_words=30))
    model = tapi.APSLDA(job, device="cpu", **QUIET).fit()
    docs = [tc.w[s:s + n] for s, n in zip(tc.doc_start[:5],
                                          tc.doc_len[:5])]
    theta = model.transform(docs)
    assert theta.shape == (5, 8)
    np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-3)
