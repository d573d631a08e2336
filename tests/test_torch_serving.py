"""The serving layer: engine θ bitwise and scores close to the JAX
package's on carried tables, npz interop both ways, publisher versions,
the concurrent engine, and twins of the serving-path bugfix regressions."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.api.model import TopicModel as JTopicModel
from repro.core import lightlda as jlda
from repro.infer import engine as jengine
from repro.infer import foldin as jfold
from repro.infer import snapshot as jsnapshot
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.api import TopicModel
from repro_torch.core import lightlda as tlda
from repro_torch.infer import engine as tengine
from repro_torch.infer import foldin as tfold
from repro_torch.infer import snapshot as tsnapshot

K, V = 4, 40


def _peaked_counts(seed=0, k=K, v=V, tokens_per_topic=500):
    """Topic k owns the vocab slice [k*V/K, (k+1)*V/K), plus smoothing."""
    rng = np.random.default_rng(seed)
    nwk = np.ones((v, k), np.int32)
    span = v // k
    for t in range(k):
        np.add.at(nwk[:, t], rng.integers(t * span, (t + 1) * span,
                                          tokens_per_topic), 1)
    return nwk, nwk.sum(0)


def _tcfg(**kw):
    return tlda.LDAConfig(num_topics=K, vocab_size=V, **kw)


def _ecfg(mod, fold, **kw):
    return mod.EngineConfig(max_batch=kw.pop("max_batch", 4), min_bucket=16,
                            foldin=fold.FoldInConfig(num_sweeps=10, burnin=4),
                            **kw)


def _carried_snapshots(seed=0):
    """A JAX snapshot, and the port's snapshot holding the same tables."""
    nwk, nk = _peaked_counts(seed)
    jcfg = jlda.LDAConfig(num_topics=K, vocab_size=V)
    js = jsnapshot.build_snapshot(jnp.asarray(nwk), jnp.asarray(nk), jcfg,
                                  version=1)
    model = convert.frozen_model_from_arrays(*(np.asarray(x)
                                               for x in js.model),
                                             device="cpu")
    ts = tsnapshot.Snapshot(1, model, torch.tensor(np.asarray(js.phi)),
                            torch.tensor(np.asarray(js.p_coll)), _tcfg())
    return js, ts


def _docs(n, seed, lo=4, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi, n)]


def _engine(max_batch=4, max_len=1024, seed=0):
    nwk, nk = _peaked_counts(seed)
    pub = tsnapshot.SnapshotPublisher(_tcfg())
    pub.publish(torch.from_numpy(nwk), torch.from_numpy(nk))
    return tengine.QueryEngine(pub, _ecfg(tengine, tfold, max_batch=max_batch,
                                          max_len=max_len))


# -- parity with the JAX package -------------------------------------------

def test_query_engine_theta_bitwise_and_scores_close_vs_jax():
    js, ts = _carried_snapshots()
    jeng = jengine.QueryEngine(js, _ecfg(jengine, jfold))
    teng = tengine.QueryEngine(ts, _ecfg(tengine, tfold))
    docs = _docs(7, seed=1)
    seeds = list(range(50, 57))
    jres, tres = jeng.infer(docs, seeds), teng.infer(docs, seeds)
    for a, b in zip(jres, tres):
        assert a.version == b.version
        np.testing.assert_array_equal(a.theta.view(np.int32),
                                      b.theta.view(np.int32))
    queries = [np.array([1, 2, 3], np.int32), np.array([25, 26], np.int32)]
    want = jeng.score(jres, docs, queries)
    got = teng.score(tres, docs, queries)
    assert got.shape == want.shape == (2, 7)
    # the einsum over K may sum in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_build_snapshot_matches_jax():
    nwk, nk = _peaked_counts(3)
    js = jsnapshot.build_snapshot(jnp.asarray(nwk), jnp.asarray(nk),
                                  jlda.LDAConfig(num_topics=K, vocab_size=V),
                                  version=4)
    ts = tsnapshot.build_snapshot(torch.from_numpy(nwk), torch.from_numpy(nk),
                                  _tcfg(), version=4)
    assert ts.version == 4 and ts.device.type == "cpu"
    np.testing.assert_array_equal(ts.phi.numpy(), np.asarray(js.phi))
    np.testing.assert_array_equal(ts.model.nwk.numpy(),
                                  np.asarray(js.model.nwk))
    np.testing.assert_allclose(ts.p_coll.numpy(), np.asarray(js.p_coll),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ts.p_coll.sum()), 1.0, atol=1e-5)


def test_topic_model_npz_round_trips_both_ways(tmp_path):
    nwk, nk = _peaked_counts(4)
    jcfg = jlda.LDAConfig(num_topics=K, vocab_size=V, alpha=0.2, mh_steps=3,
                          block_tokens=512, num_shards=2)
    # written by the JAX package, loaded by the port
    JTopicModel(jnp.asarray(nwk), jnp.asarray(nk), jcfg).save(
        str(tmp_path / "j.npz"))
    tm = TopicModel.load(str(tmp_path / "j.npz"), device="cpu")
    np.testing.assert_array_equal(tm.nwk, nwk)
    np.testing.assert_array_equal(tm.nk, nk)
    assert (tm.cfg.alpha, tm.cfg.mh_steps, tm.cfg.block_tokens,
            tm.cfg.num_shards) == (0.2, 3, 512, 2)
    # written by the port, loaded by the JAX package
    tm.save(str(tmp_path / "t.npz"))
    jm = JTopicModel.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(jm.nwk, nwk)
    np.testing.assert_array_equal(jm.nk, nk)
    assert jm.cfg == jcfg
    # and the carried model serves the same θ as one built from arrays
    again = convert.topic_model_from_arrays(jm.nwk, jm.nk, vars(jm.cfg),
                                            device="cpu")
    doc = [np.arange(10, dtype=np.int32)]
    np.testing.assert_array_equal(again.transform(doc, [1]),
                                  tm.transform(doc, [1]))


# -- the port's own serving behaviour ----------------------------------------

def test_topic_model_on_cpu_end_to_end():
    nwk, nk = _peaked_counts(5)
    m = TopicModel(nwk, nk, _tcfg(), device="cpu",
                   ecfg=_ecfg(tengine, tfold))
    span = V // K
    docs = [np.arange(t * span, (t + 1) * span, dtype=np.int32)
            for t in range(K)]
    theta = m.transform(docs)
    assert theta.shape == (K, K)
    np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-5)
    assert (theta.argmax(1) == np.arange(K)).all()
    scores = m.score([docs[0][:3], docs[2][:3]], docs)
    assert scores.shape == (2, K) and np.isfinite(scores).all()
    assert scores[0].argmax() == 0 and scores[1].argmax() == 2
    assert m.top_words(3).shape == (K, 3)
    assert m.publisher().version == 1
    assert "device=cpu" in repr(m)


def test_snapshot_versions_monotonic_and_pinned():
    nwk, nk = _peaked_counts(6)
    pub = tsnapshot.SnapshotPublisher(_tcfg())
    assert pub.acquire() is None
    versions, held = [], None
    for i in range(5):
        snap = pub.publish(torch.from_numpy(nwk + i), torch.from_numpy(nk))
        versions.append(snap.version)
        if i == 1:
            held = pub.acquire()
        assert pub.acquire().version == snap.version == pub.version
    assert versions == list(range(1, 6))
    assert held.version == 2
    assert int(held.model.nwk[0, 0]) == int(nwk[0, 0]) + 1


def test_concurrent_engine_one_result_per_ticket_same_theta():
    eng = _engine(max_batch=4)
    docs = _docs(18, seed=7)
    seeds = [200 + i for i in range(len(docs))]
    want = [r.theta for r in eng.infer(docs, seeds)]
    tickets = {}
    lock = threading.Lock()
    with tengine.ConcurrentEngine(eng, max_delay_ms=2.0) as ceng:
        def client(c):
            for i in range(c, len(docs), 3):
                t = ceng.submit(docs[i], seed=seeds[i])
                with lock:
                    tickets[i] = t
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        results = {i: t.result(timeout=60) for i, t in tickets.items()}
    assert sorted(results) == list(range(len(docs)))
    assert len({r.rid for r in results.values()}) == len(docs)
    assert ceng.served == len(docs) and ceng.shed == ceng.failed == 0
    for i, r in results.items():
        np.testing.assert_array_equal(r.theta, want[i])


def test_concurrent_engine_sheds_past_deadline():
    eng = _engine()
    with tengine.ConcurrentEngine(eng, max_delay_ms=60_000.0) as ceng:
        t = ceng.submit(np.arange(5, dtype=np.int32), seed=1,
                        deadline_ms=1.0)
        with pytest.raises(tengine.DeadlineExceeded):
            t.result(timeout=30)
    assert ceng.shed == 1 and ceng.served == 0


# -- twins of tests/test_infer.py::TestServingBugfixes ------------------------

def test_t_submit_never_leaks_when_obs_toggles():
    eng = _engine()
    s = tobs.ObsSession(tobs.ObsConfig(enabled=True, trace=False)).install()
    try:
        for i in range(5):
            eng.submit(np.arange(8, dtype=np.int32), seed=i)
        assert len(eng._t_submit) == 5
    finally:
        s.close(save=False)                 # obs OFF before the flush
    assert len(eng.flush()) == 5
    assert eng._t_submit == {}


def test_t_submit_empty_with_obs_off():
    eng = _engine()
    for i in range(3):
        eng.submit(np.arange(8, dtype=np.int32), seed=i)
    assert eng._t_submit == {}
    eng.flush()
    assert eng._t_submit == {}


def test_publish_orders_version_after_flip():
    """A ``version`` read before ``acquire()`` is a lower bound on the
    acquired snapshot's version, and acquired versions are monotonic."""
    nwk, nk = (torch.from_numpy(a) for a in _peaked_counts(8))
    pub = tsnapshot.SnapshotPublisher(_tcfg())
    pub.publish(nwk, nk)
    stop = threading.Event()
    violations = []

    def reader():
        last = -1
        while not stop.is_set():
            v_before = pub.version
            snap = pub.acquire()
            if snap.version < v_before:
                violations.append((v_before, snap.version))
            if snap.version < last:
                violations.append(("non-monotonic", last, snap.version))
            last = snap.version
            time.sleep(0)    # yield the GIL: publishing runs many torch ops

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    for _ in range(20):
        pub.publish(nwk, nk)
    stop.set()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert not violations, violations[:5]


def test_submit_truncates_at_max_len_boundary():
    eng = _engine(max_len=32)
    for n in (31, 32, 33):
        eng.submit((np.arange(n) % V).astype(np.int32), seed=7)
    assert [len(r.tokens) for r in eng._queue] == [31, 32, 32]
    eng._queue.clear()
    long_doc = (np.arange(33) % V).astype(np.int32)
    r_long = eng.infer([long_doc], seeds=[3])[0]
    r_pref = eng.infer([long_doc[:32]], seeds=[3])[0]
    np.testing.assert_array_equal(r_long.theta, r_pref.theta)


def test_score_pack_lengths_bucketed(monkeypatch):
    """``score()`` packs docs and queries at bucket lengths, not at the
    exact max length, so a long-lived server sees few distinct shapes."""
    eng = _engine()
    seen = []
    real = tengine.topic_smoothed_scores

    def spy(theta, doc_w, doc_valid, q_w, q_valid, *rest):
        seen.append((doc_w.shape[1], q_w.shape[1]))
        return real(theta, doc_w, doc_valid, q_w, q_valid, *rest)

    monkeypatch.setattr(tengine, "topic_smoothed_scores", spy)
    rng = np.random.default_rng(0)
    for ld, lq in ((17, 5), (25, 9), (30, 14), (40, 5)):
        docs = [rng.integers(0, V, ld).astype(np.int32)]
        qs = [rng.integers(0, V, lq).astype(np.int32)]
        eng.score(eng.infer(docs, seeds=[0]), docs, qs)
    assert seen == [(32, 16), (32, 16), (32, 16), (64, 16)]
