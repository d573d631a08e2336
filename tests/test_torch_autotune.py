"""The port's route/staleness autotuner against the JAX package's.

The autotuner only *selects* among routes and staleness bounds whose
results are bitwise-identical by construction.  What is deterministic is
held bitwise against the JAX package on the same numpy inputs: the
candidate grid, the cost model, ``sample_reassign``'s draws, the
validation messages.  The choice itself is a timing, so an ``"auto"`` fit
is held against the JAX package's fit run with the plan the port chose.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi
from repro import ps as jps
from repro.data import corpus as jcorpus_mod
from repro.ps import autotune as jtune
from repro.train import async_exec as jexec
from repro_torch import api as tapi
from repro_torch import obs as tobs
from repro_torch import ps as tps
from repro_torch import rng as trng
from repro_torch.data import corpus as tcorpus_mod
from repro_torch.ps import autotune as ttune
from repro_torch.train import async_exec as texec

QUIET = dict(log_fn=lambda *a, **kw: None)


def _zipf_words(n, v, seed=0, a=1.3):
    rng = np.random.default_rng(seed)
    return (rng.zipf(a, n) - 1).clip(0, v - 1).astype(np.int32)


def _jax_route(chosen):
    """The JAX package's route for a report's ``chosen`` entry."""
    if chosen["hot_words"] is not None:
        return jps.HybridRoute(hot_words=chosen["hot_words"])
    return {"dense": jps.DenseRoute(), "coo": jps.CooRoute()}[chosen["route"]]


class TestCostModel:
    def test_candidate_grid_equals_jax(self):
        for v in (1, 64, 65, 2000, 100_000):
            t = [(r.label, getattr(r, "hot_words", None))
                 for r in ttune.candidate_routes(v)]
            j = [(r.label, getattr(r, "hot_words", None))
                 for r in jtune.candidate_routes(v)]
            assert t == j
        hots = [r.hot_words for r in ttune.candidate_routes(2000)[2:]]
        assert hots == [64, 128, 256, 512, 1024]

    def test_word_frequencies_and_hot_fraction_equal_jax(self):
        w = _zipf_words(5000, 100)
        valid = np.random.default_rng(1).random(5000) < 0.8
        for vv in (None, valid):
            tf = ttune.word_frequencies(
                torch.from_numpy(w), None if vv is None
                else torch.from_numpy(vv), 100)
            jf = jtune.word_frequencies(jnp.asarray(w), vv, 100)
            np.testing.assert_array_equal(tf, np.asarray(jf))
        fr = [ttune.hot_fraction(tf, h) for h in (0, 1, 10, 100)]
        assert fr == [jtune.hot_fraction(tf, h) for h in (0, 1, 10, 100)]
        assert fr[0] == 0.0 and fr[-1] == 1.0
        assert all(a <= b for a, b in zip(fr, fr[1:]))

    def test_predicted_cost_equals_jax_over_a_grid(self):
        v, k = 1000, 32
        freqs = [np.zeros(v, np.int64),
                 np.bincount(_zipf_words(20000, v), minlength=v)]
        freqs[0][:64] = 100
        for freq in freqs:
            for b in (1, 512, 8192):
                for tr, jr in zip(ttune.candidate_routes(v),
                                  jtune.candidate_routes(v)):
                    assert (ttune.predicted_cost(tr, b, v, k, freq)
                            == jtune.predicted_cost(jr, b, v, k, freq))
        freq = freqs[0]
        dense_c = ttune.predicted_cost(tps.DenseRoute(), 512, v, k, freq)
        assert dense_c == v * k
        hyb_c = ttune.predicted_cost(tps.HybridRoute(hot_words=64), 512, v,
                                     k, freq)
        assert hyb_c < ttune.predicted_cost(tps.CooRoute(), 512, v, k, freq)
        assert hyb_c < dense_c

    @pytest.mark.parametrize("valid", [False, True])
    def test_sample_reassign_equals_jax(self, valid):
        w = _zipf_words(4000, 50)
        vv = (np.random.default_rng(3).random(4000) < 0.5) if valid else None
        tre = ttune.sample_reassign(
            torch.from_numpy(w), None if vv is None else torch.from_numpy(vv),
            256, 8, seed=1, device="cpu")
        jre = jtune.sample_reassign(jnp.asarray(w), vv, 256, 8, seed=1)
        for a, b in zip(tre, jre):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tre.rows.shape == (256,) and bool(tre.changed.all())
        assert int(tre.rows.max()) < 50
        assert not bool((tre.z_old == tre.z_new).any())


class TestMeasurement:
    def test_autotune_route_returns_measured_report(self):
        v, k = 60, 8
        w = torch.from_numpy(_zipf_words(3000, v))
        route, report = ttune.autotune_route(w, None, v, k, batch=128,
                                             iters=2, device="cpu")
        labels = {r["route"] for r in report["measured"]}
        assert {"dense", "coo"} <= labels       # references always timed
        assert report["chosen_route"] == route.label
        _, jreport = jtune.autotune_route(jnp.asarray(w.numpy()), None, v,
                                          k, batch=128, iters=2)
        assert report["predicted_order"] == jreport["predicted_order"]
        assert ([r["route"] for r in report["measured"]]
                == [r["route"] for r in jreport["measured"]])
        for row, jrow in zip(report["measured"], jreport["measured"]):
            assert row["apply_ms"] > 0 and row["plan_ms"] > 0
            assert row["traffic"] == jrow["traffic"]
            assert row["hot_prefix"] == jrow["hot_prefix"]

    def test_measure_routes_leaves_values_alone(self):
        """Timing a route's push_plan never changes the table it was
        given (the handle is functional)."""
        client = tps.PSClient.create()
        h = client.matrix(40, 5, device="cpu")
        re = ttune.sample_reassign(torch.from_numpy(_zipf_words(500, 40)),
                                   None, 64, 5, device="cpu")
        rows = ttune.measure_routes(h, re, [tps.DenseRoute(),
                                            tps.HybridRoute(hot_words=8)],
                                    iters=2, repeats=1)
        assert [r["route"] for r in rows] == ["dense", "hybrid"]
        assert int(h.value.abs().sum()) == 0

    def test_observed_push_ms_roundtrip(self):
        """Histograms the obs plane recorded under ps.push_ms.* surface in
        the report."""
        s = tobs.ObsSession(tobs.ObsConfig(enabled=True)).install()
        try:
            reg = tobs.metrics_registry()
            reg.histogram("ps.push_ms.hybrid").record(1.5)
            seen = ttune.observed_push_ms()
            assert "hybrid" in seen and seen["hybrid"]["count"] == 1
        finally:
            s.close(save=False)
        assert ttune.observed_push_ms() == {}


def _job_states(route="auto", staleness="auto", **kw):
    """The same tiny job's initial state in both packages: ``(cfg, state,
    exec_cfg)`` of the port, with ``route``/``staleness`` in ``exec_cfg``,
    and ``(cfg, state)`` of the JAX package."""
    args = dict(num_docs=60, vocab_size=80, model_topics=6, mean_doc_len=30,
                seed=0)
    base = dict(num_topics=6, block_tokens=256, sweeps=1, eval_every=0, **kw)
    tsess = tapi.Session(tapi.LDAJob(
        corpus=tcorpus_mod.synthetic_corpus(**args), **base), device="cpu",
        **QUIET)
    jsess = japi.Session(japi.LDAJob(
        corpus=jcorpus_mod.synthetic_corpus(**args), **base), **QUIET)
    tst, _, _ = tsess.make_step()
    jst, _, _ = jsess.make_step()
    exec_cfg = dataclasses.replace(tsess.job.exec_config(), route=route,
                                   staleness=staleness)
    return (tsess.cfg, tst, exec_cfg), (jsess.cfg, jst)


class TestResolveExec:
    def test_resolve_exec_concretises_auto(self):
        (cfg, state, exec_cfg), _ = _job_states()
        assert exec_cfg.wants_autotune()
        concrete, report = ttune.resolve_exec(state, cfg, exec_cfg)
        assert isinstance(concrete.route, tps.PushRoute)
        assert isinstance(concrete.staleness, int)
        assert not concrete.wants_autotune()
        assert report["chosen"]["route"] == concrete.route.label
        assert report["chosen"]["staleness"] == concrete.staleness
        assert "route" in report and "staleness" in report
        assert ([r["staleness"] for r in report["staleness"]["measured"]]
                == sorted({r["staleness"]
                           for r in report["staleness"]["measured"]}))

    def test_make_executor_resolves_auto_and_reports(self):
        (cfg, state, exec_cfg), (jcfg, jst) = _job_states(staleness=0)
        step, info = texec.make_executor(state, cfg, exec_cfg)
        assert "autotune" in info
        assert info["autotune"]["chosen"]["staleness"] == 0
        out = step(state, trng.PRNGKey(0))          # the step actually runs
        assert out.z.shape == state.z.shape
        jstep, _ = jexec.make_executor(jst, jcfg, dataclasses.replace(
            jexec.ExecConfig(), route=_jax_route(info["autotune"]["chosen"]),
            staleness=0))
        jout = jstep(jst, jax.random.PRNGKey(0))
        np.testing.assert_array_equal(out.z.numpy(), np.asarray(jout.z))

    @pytest.mark.parametrize("blocks", [0, 4])
    def test_auto_choice_never_changes_values(self, blocks):
        """Whatever the tuner picks, the sampled state is bitwise the
        synchronous dense reference's, and the JAX package's."""
        (cfg, state, exec_cfg), (jcfg, jst) = _job_states(
            route="auto", staleness=0, model_blocks=blocks)
        step_auto, info = texec.make_executor(state, cfg, exec_cfg)
        step_ref, _ = texec.make_executor(state, cfg, dataclasses.replace(
            exec_cfg, route=tps.DenseRoute()))
        a = step_auto(state, trng.PRNGKey(7))
        b = step_ref(state, trng.PRNGKey(7))
        assert torch.equal(a.z, b.z)
        assert torch.equal(a.nwk.to_dense(), b.nwk.to_dense())
        jstep, _ = jexec.make_executor(jst, jcfg, jexec.ExecConfig(
            route=jps.DenseRoute(), model_blocks=blocks))
        j = jstep(jst, jax.random.PRNGKey(7))
        np.testing.assert_array_equal(a.nwk.to_dense().numpy(),
                                      np.asarray(j.nwk.to_dense()))

    def test_auto_fit_equals_jax_fit_with_the_chosen_plan(self):
        """route and staleness "auto", blocked executor: the fit equals the
        JAX package's fit run with the route and staleness the port
        chose, in n_wk, n_k and every perplexity."""
        corp_args = dict(num_docs=70, vocab_size=250, true_topics=6, seed=5)
        base = dict(num_topics=8, block_tokens=512, sweeps=2, eval_every=1,
                    seed=3, model_blocks=4)
        tm = tapi.APSLDA(tapi.LDAJob(
            corpus=tcorpus_mod.synthetic_corpus(**corp_args), route="auto",
            staleness="auto", **base), device="cpu", **QUIET).fit()
        chosen = tm.info["autotune"]["chosen"]
        assert tm.info["staleness"] == chosen["staleness"]
        jm = japi.APSLDA(japi.LDAJob(
            corpus=jcorpus_mod.synthetic_corpus(**corp_args),
            route=_jax_route(chosen), staleness=chosen["staleness"], **base),
            **QUIET).fit()
        np.testing.assert_array_equal(tm.nwk, np.asarray(jm.nwk))
        np.testing.assert_array_equal(tm.nk, np.asarray(jm.nk))
        np.testing.assert_allclose([r["perplexity"] for r in tm.history],
                                   [r["perplexity"] for r in jm.history],
                                   rtol=1e-5)

    def test_stream_executor_rejects_auto(self):
        for auto in (dict(route="auto"), dict(staleness="auto")):
            with pytest.raises(ValueError, match="make_executor") as te:
                texec.make_stream_executor(
                    tapi.LDAJob(docs=[[0, 1]]).lda_config(10),
                    texec.ExecConfig(**auto), None)
            with pytest.raises(ValueError) as je:
                jexec.ExecConfig(**auto).resolve_route(10)
            assert str(te.value) == str(je.value)

    def test_tiered_storage_rejects_auto(self, tmp_path):
        """make_tiered_executor refuses "auto" with the JAX package's
        message."""
        (cfg, state, _), (jcfg, jst) = _job_states(route=None, staleness=0)
        th = tps.tiered_matrix_from_dense(state.nwk.to_dense(), 8,
                                          str(tmp_path / "t"), device="cpu")
        jh = jps.tiered_matrix_from_dense(jst.nwk.to_dense(), 8,
                                          str(tmp_path / "j"))
        msgs = []
        for ex, st in ((texec, state._replace(nwk=th)),
                       (jexec, jst._replace(nwk=jh))):
            with pytest.raises(ValueError, match="tiered") as e:
                ex.make_tiered_executor(st, cfg, ex.ExecConfig(
                    route="auto", model_blocks=2))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    @pytest.mark.parametrize("bad", [
        dict(stream_dir=".", route="auto"),
        dict(docs=[[0, 1]], backend="spmd", staleness="auto"),
        dict(docs=[[0, 1]], route="fastest"),
        dict(docs=[[0, 1]], staleness="soon"),
        dict(docs=[[0, 1]], storage="tiered", model_blocks=2,
             staleness="auto"),
    ])
    def test_job_validation_gates_auto(self, bad):
        tp = tapi.LDAJob(**bad).problems()
        jp = japi.LDAJob(**bad).problems()
        assert tp == jp and tp
