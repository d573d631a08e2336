"""The port's ``TopicService`` against the JAX package's: the same training
publishes the same versions and a bitwise-equal final snapshot, fold-in θ
is bitwise, scores agree within rtol 1e-5, publishing never perturbs
training, and live refresh serves concurrent clients with at least one
swap."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import lightlda as jlda
from repro.data import corpus as jcorpus
from repro.infer.engine import EngineConfig as JEngineConfig
from repro.infer.foldin import FoldInConfig as JFoldInConfig
from repro.serve.topic_service import TopicService as JTopicService
from repro.train.async_exec import ExecConfig as JExecConfig
from repro_torch import api as tapi
from repro_torch import rng as jrng
from repro_torch.api.callbacks import PublishCallback
from repro_torch.api.session import memory_fit
from repro_torch.core import lightlda as tlda
from repro_torch.infer.engine import DeadlineExceeded, EngineConfig
from repro_torch.infer.foldin import FoldInConfig
from repro_torch.infer.snapshot import SnapshotPublisher
from repro_torch.serve import TopicService
from repro_torch.train.async_exec import ExecConfig

SWEEPS, PUBLISH_EVERY = 4, 2
EXEC = dict(staleness=1, hot_words=40)


@pytest.fixture(scope="module")
def corpus():
    corp = jcorpus.synthetic_corpus(90, 300, true_topics=6, seed=2)
    return jcorpus.train_heldout_split(corp, 0.15, seed=3)


def _cfg(pkg):
    return pkg.LDAConfig(num_topics=8, vocab_size=300, block_tokens=512)


def _ecfg(pkg_engine, pkg_foldin):
    return pkg_engine(max_batch=8, foldin=pkg_foldin(num_sweeps=12,
                                                     burnin=4))


def _docs(corp, n):
    return [corp.w[s:s + l] for s, l in zip(corp.doc_start[:n],
                                             corp.doc_len[:n])]


@pytest.fixture(scope="module")
def services(corpus):
    train, _ = corpus
    jsvc = JTopicService(_cfg(jlda), _ecfg(JEngineConfig, JFoldInConfig),
                         exec_cfg=JExecConfig(**EXEC))
    jsvc.init_from_corpus(train, seed=1)
    jsnap = jsvc.train(SWEEPS, jax.random.PRNGKey(7),
                       publish_every=PUBLISH_EVERY)
    tsvc = TopicService(_cfg(tlda), _ecfg(EngineConfig, FoldInConfig),
                        exec_cfg=ExecConfig(**EXEC), device="cpu")
    tsvc.init_from_corpus(train, seed=1)
    tsnap = tsvc.train(SWEEPS, jrng.PRNGKey(7), publish_every=PUBLISH_EVERY)
    return jsvc, jsnap, tsvc, tsnap


def test_train_publishes_the_jax_snapshot(services):
    jsvc, jsnap, tsvc, tsnap = services
    assert tsvc.version == jsvc.version == 1 + SWEEPS // PUBLISH_EVERY
    assert tsnap.version == jsnap.version
    np.testing.assert_array_equal(tsvc.state.nwk.to_dense().numpy(),
                                  np.asarray(jsvc.state.nwk.to_dense()))
    np.testing.assert_array_equal(tsnap.phi.numpy(), np.asarray(jsnap.phi))
    np.testing.assert_array_equal(tsnap.model.aprob.numpy(),
                                  np.asarray(jsnap.model.aprob))
    np.testing.assert_array_equal(tsnap.model.aalias.numpy(),
                                  np.asarray(jsnap.model.aalias))
    np.testing.assert_array_equal(tsnap.p_coll.numpy(),
                                  np.asarray(jsnap.p_coll))
    assert tsnap.device.type == "cpu"


def test_fold_in_and_score_match_jax(services, corpus):
    jsvc, _, tsvc, _ = services
    docs = _docs(corpus[1], 6)
    seeds = [11 * i for i in range(len(docs))]
    jres = jsvc.fold_in(docs, seeds=seeds)
    tres = tsvc.fold_in(docs, seeds=seeds)
    for j, t in zip(jres, tres):
        np.testing.assert_array_equal(t.theta, j.theta)
        assert t.version == j.version
    queries = [d[:3] for d in docs[:3]]
    np.testing.assert_allclose(tsvc.score(queries, docs, tres),
                               jsvc.score(queries, docs, jres), rtol=1e-5)


def test_publishing_never_perturbs_training(corpus):
    train, _ = corpus
    cfg = _cfg(tlda)
    finals = []
    for publish in (False, True):
        state = tlda.init_state(jrng.PRNGKey(4), torch.from_numpy(train.w),
                                torch.from_numpy(train.d), train.num_docs,
                                cfg)
        pub = SnapshotPublisher(cfg)
        cbs = [PublishCallback(pub, every=1, include_last=True)] \
            if publish else []
        st, _, _ = memory_fit(state, jrng.PRNGKey(5), cfg,
                              ExecConfig(**EXEC), 3, eval_every=0,
                              log_fn=lambda *a: None, callbacks=cbs)
        finals.append(st)
        if publish:
            assert cbs[0].versions == [1, 2, 3, 4] and pub.version == 4
    a, b = finals
    assert torch.equal(a.nwk.value, b.nwk.value)
    assert torch.equal(a.nk.value, b.nk.value)
    assert torch.equal(a.ndk, b.ndk) and torch.equal(a.z, b.z)


def test_train_async_serves_concurrent_clients_with_a_swap(corpus):
    train, _ = corpus
    svc = TopicService(_cfg(tlda), _ecfg(EngineConfig, FoldInConfig),
                       exec_cfg=ExecConfig(**EXEC), device="cpu")
    svc.init_from_corpus(train, seed=1)
    svc.train(1, jrng.PRNGKey(2))
    svc.start_serving(max_delay_ms=2.0)
    v0 = svc.version
    trainer = svc.train_async(3, jrng.PRNGKey(3), publish_every=1)
    served, shed, errors = [], [], []
    lock = threading.Lock()

    def client(ci):
        rng = np.random.default_rng(ci)
        tickets = [svc.submit(rng.integers(0, 300, 20).astype(np.int32),
                              seed=100 * ci + i) for i in range(6)]
        for t in tickets:
            try:
                r = t.result(timeout=120)
                with lock:
                    served.append(r)
            except DeadlineExceeded as exc:
                with lock:
                    shed.append(exc)
            except Exception as exc:   # noqa: BLE001 -- the verdict
                with lock:
                    errors.append(exc)

    threads = [threading.Thread(target=client, args=(ci,))
               for ci in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    final = trainer.join(timeout=120)
    assert not trainer.running
    svc.stop_serving()
    assert not errors
    assert len(served) + len(shed) == 18
    assert all(abs(r.theta.sum() - 1.0) < 1e-3 for r in served)
    assert svc.version - v0 >= 1 and final.version == svc.version
    assert svc.serving is None


def test_publisher_handoff_to_service(corpus):
    train, held = corpus
    model = tapi.APSLDA(tapi.LDAJob(corpus=train, num_topics=8,
                                    block_tokens=512, sweeps=2,
                                    eval_every=0),
                        device="cpu", log_fn=lambda *a: None).fit()
    pub = model.publisher()
    assert pub.version == 1
    svc = TopicService(model.cfg, publisher=pub, device="cpu")
    docs = _docs(held, 3)
    results = svc.fold_in(docs, seeds=[0, 1, 2])
    assert len(results) == 3
    assert all(r.version == 1 for r in results)
    np.testing.assert_array_equal(np.stack([r.theta for r in results]),
                                  model.transform(docs, seeds=[0, 1, 2]))


def test_service_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TopicService(_cfg(tlda))
