"""The port's tiered parameter storage against the JAX package's.

The load-bearing guarantee is the **composition invariant**: after any
schedule of pulls, pushes, promotions, evictions and resizes, the hot tier
composed over the cold memmap equals the single-tier oracle table bitwise.
Here each case runs the same numpy inputs through both packages and holds
the port to the oracle *and* to the JAX package: the composed table, the
residency (``ids``/``slot_of``), the tier's stats and the cold-store
directory, byte for byte.  A whole ``storage="tiered"`` fit on the CPU gives
the JAX package's z and count tables bitwise.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import api as japi
from repro import ps as jps
from repro.data.corpus import synthetic_corpus as jcorpus
from repro.ps.autotune import retune_hot_rows as j_retune
from repro.ps.autotune import size_hot_rows as j_size
from repro.ps.coldstore import ColdStore as JColdStore
from repro_torch import api as tapi
from repro_torch import ps as tps
from repro_torch.data.corpus import synthetic_corpus as tcorpus
from repro_torch.ps.autotune import retune_hot_rows as t_retune
from repro_torch.ps.autotune import size_hot_rows as t_size
from repro_torch.ps.coldstore import ColdStore as TColdStore

QUIET = dict(log_fn=lambda m: None)


def _dir_bytes(path):
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def _make(tmp_path, v=40, k=6, hot=8, seed=0, name="tier"):
    """Tiered handles of both packages plus the int64 numpy oracle, from the
    same initial counts."""
    rng = np.random.default_rng(seed)
    dense = rng.integers(0, 50, size=(v, k)).astype(np.int32)
    th = tps.tiered_matrix_from_dense(torch.from_numpy(dense), hot,
                                      str(tmp_path / f"{name}-t"),
                                      device="cpu")
    jh = jps.tiered_matrix_from_dense(jnp.asarray(dense), hot,
                                      str(tmp_path / f"{name}-j"))
    return dense.astype(np.int64), th, jh


def _reassign(v, k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, v, size=n).astype(np.int32)
    zo = rng.integers(0, k, n, np.int32)
    zn = rng.integers(0, k, n, np.int32)
    return w, zo, zn, rng.random(n) < 0.7


def _tre(b):
    w, zo, zn, ch = (torch.from_numpy(x) for x in b)
    return tps.Reassign(w, w, zo, zn, ch)


def _jre(b):
    w, zo, zn, ch = (jnp.asarray(x) for x in b)
    return jps.Reassign(w, w, zo, zn, ch)


def _push_both(th, jh, oracle, b):
    th.push(_tre(b))
    jh.push(_jre(b))
    w, zo, zn, ch = b
    ok = ch & (w < oracle.shape[0])
    np.add.at(oracle, (w[ok], zo[ok]), -1)
    np.add.at(oracle, (w[ok], zn[ok]), 1)


def _coo_both(th, jh, oracle, rows, cols, vals):
    th.push_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                torch.from_numpy(vals))
    jh.push_coo(rows, cols, vals)
    ok = (rows >= 0) & (rows < oracle.shape[0])
    np.add.at(oracle, (rows[ok], cols[ok]), vals[ok])


def _assert_same(th, jh, oracle):
    """Composed table == oracle == JAX's, residency and stats equal."""
    got = th.to_dense().numpy().astype(np.int64)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, np.asarray(jh.to_dense(), np.int64))
    np.testing.assert_array_equal(th.tier.ids, jh.tier.ids)
    np.testing.assert_array_equal(th.tier.slot_of, jh.tier.slot_of)
    np.testing.assert_array_equal(th.tier.traffic, jh.tier.traffic)
    assert th.tier.hot_rows == jh.tier.hot_rows
    assert th.tier_stats().to_json() == jh.tier_stats().to_json()


class TestColdStore:
    def test_roundtrip_reopen_and_cross_package(self, tmp_path):
        """Directories byte-equal for the same writes; each package reopens
        the other's store and reads the same rows."""
        dense = np.arange(24, dtype=np.int32).reshape(6, 4)
        stores = {"t": TColdStore.from_dense(str(tmp_path / "t"), dense),
                  "j": JColdStore.from_dense(str(tmp_path / "j"), dense)}
        for cold in stores.values():
            np.testing.assert_array_equal(cold.to_array(), dense)
            cold.write_rows(np.array([1, 5]), np.full((2, 4), 7, np.int32))
            cold.add_rows(np.array([2, 2]), np.ones((2, 4), np.int32))
            cold.flush()
        assert (_dir_bytes(str(tmp_path / "t"))
                == _dir_bytes(str(tmp_path / "j")))
        for opener, other in ((TColdStore, "j"), (JColdStore, "t")):
            reopened = opener.open(str(tmp_path / other))
            assert reopened.shape == (6, 4)
            np.testing.assert_array_equal(
                reopened.read_rows(np.array([1, 5, 2])),
                stores["t"].read_rows(np.array([1, 5, 2])))
        out = np.empty((2, 4), np.int32)
        got = stores["t"].read_rows(np.array([5, 0]), out=out)
        assert got is out
        np.testing.assert_array_equal(out, stores["j"].read_rows([5, 0]))

    def test_apply_coo_out_of_range_is_noop(self, tmp_path):
        args = (np.array([0, 7, -1, 4]), np.array([1, 0, 2, 2]),
                np.array([3, 9, 9, 2], np.int32))
        outs = []
        for name, cls in (("t", TColdStore), ("j", JColdStore)):
            cold = cls.create(str(tmp_path / name), 5, 3)
            cold.apply_coo(*args)
            outs.append(cold.to_array())
        np.testing.assert_array_equal(outs[0], outs[1])
        assert outs[0][0, 1] == 3 and outs[0][4, 2] == 2
        assert outs[0].sum() == 5


class TestComposition:
    def test_pull_composes_hot_and_cold(self, tmp_path):
        oracle, th, jh = _make(tmp_path, v=30, k=5, hot=6)
        for rows in (np.array([0, 3, 5, 6, 17, 29]), np.array([1, 2]),
                     np.array([20, 10])):          # mixed, hot, cold
            got = th.pull(rows).result()
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), oracle[rows])
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jh.pull(rows).result()))
        block = th.pull_block(1, 7).result()
        np.testing.assert_array_equal(block.numpy(), oracle[7:14])
        jh.pull_block(1, 7).result()
        assert th.tier_stats().to_json() == jh.tier_stats().to_json()

    def test_mixed_schedule_matches_oracle_and_jax(self, tmp_path):
        """Pulls/pushes/refreshes/resizes in any order keep the composed
        table bitwise equal to the single-tier oracle, and the residency
        (eviction order included) equal to the JAX package's."""
        v, k = 40, 6
        oracle, th, jh = _make(tmp_path, v=v, k=k, hot=8)
        rng = np.random.default_rng(1)
        for step in range(12):
            op = step % 4
            if op == 0:
                _push_both(th, jh, oracle, _reassign(v, k, 64, 100 + step))
            elif op == 1:
                rows = rng.integers(-2, v + 3, size=20).astype(np.int32)
                cols = rng.integers(0, k, size=20).astype(np.int32)
                vals = rng.integers(-2, 3, size=20).astype(np.int32)
                _coo_both(th, jh, oracle, rows, cols, vals)
            elif op == 2:
                assert th.tier.refresh() == jh.tier.refresh()
            else:
                hot = int(rng.integers(0, v + 2))
                th.resize_hot(hot)
                jh.resize_hot(hot)
            _assert_same(th, jh, oracle)
        st = th.tier_stats()
        assert st.promotions > 0 and st.evictions > 0
        assert 0.0 <= st.hit_rate() <= 1.0

    def test_store_block_overwrites_exclusively(self, tmp_path):
        oracle, th, jh = _make(tmp_path, v=25, k=4, hot=5)
        rpb, block = 8, 1
        for h in (th, jh):
            rows = h.pull_block(block, rpb).result()
            h.store_block(block, rows + 3, rpb)
        oracle[8:16] += 3
        _assert_same(th, jh, oracle)
        # row_changed=False rows may skip the write but must stay bitwise
        th.store_block(0, th.pull_block(0, rpb).result(), rpb,
                       row_changed=np.zeros(rpb, bool))
        jh.store_block(0, jh.pull_block(0, rpb).result(), rpb,
                       row_changed=np.zeros(rpb, bool))
        _assert_same(th, jh, oracle)

    def test_flush_makes_cold_tier_authoritative(self, tmp_path):
        oracle, th, jh = _make(tmp_path, v=20, k=3, hot=4)
        _push_both(th, jh, oracle, _reassign(20, 3, 40, seed=7))
        th.flush()
        jh.flush()
        np.testing.assert_array_equal(
            th.tier.cold.to_array().astype(np.int64), oracle)
        assert (_dir_bytes(str(tmp_path / "tier-t"))
                == _dir_bytes(str(tmp_path / "tier-j")))

    def test_push_plan_splits_prefix_and_coo(self, tmp_path):
        """A hybrid route's plan: the dense prefix onto the leading rows,
        the COO tail split on residency."""
        v, k = 30, 4
        oracle, th, jh = _make(tmp_path, v=v, k=k, hot=6)
        b = _reassign(v, k, 50, seed=3)
        th.push_plan(tps.HybridRoute(hot_words=10).plan(
            _tre(b), v, k, prefix_rows=True))
        jh.push_plan(jps.HybridRoute(hot_words=10).plan(
            _jre(b), v, k, prefix_rows=True))
        w, zo, zn, ch = b
        np.add.at(oracle, (w[ch], zo[ch]), -1)
        np.add.at(oracle, (w[ch], zn[ch]), 1)
        _assert_same(th, jh, oracle)


class TestBoundaryCapacity:
    @pytest.mark.parametrize("hot", [0, 1, 19, 20, 21])
    def test_boundary_hot_rows(self, tmp_path, hot):
        """H in {0, 1, V-1, V, V+1} through pull + push + refresh."""
        v, k = 20, 4
        oracle, th, jh = _make(tmp_path, v=v, k=k, hot=hot)
        assert th.tier.hot_rows == min(hot, v)
        assert th.tier.device_bytes() == min(hot, v) * k * 4
        _push_both(th, jh, oracle, _reassign(v, k, 50, seed=hot))
        _assert_same(th, jh, oracle)
        rows = np.array([0, v // 2, v - 1])
        np.testing.assert_array_equal(th.pull(rows).result().numpy(),
                                      oracle[rows])
        jh.pull(rows).result()
        th.refresh()
        jh.refresh()
        _assert_same(th, jh, oracle)


def _schedule(th, jh, oracle, v, k, ops):
    for op, seed in ops:
        if op == 0:
            _push_both(th, jh, oracle, _reassign(v, k, 16, seed))
        elif op == 1:
            rows = np.random.default_rng(seed).integers(0, v, size=8)
            for h in (th, jh):
                h.note_traffic(0, v, np.bincount(rows, minlength=v))
        elif op == 2:
            th.refresh(decay=seed % 2 == 0)
            jh.refresh(decay=seed % 2 == 0)
        else:
            th.resize_hot(seed % (v + 2))
            jh.resize_hot(seed % (v + 2))


class TestConservationProperty:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_seeded_random_schedules_conserve_counts(self, tmp_path, seed):
        """A seeded random promote/evict schedule keeps the composed table,
        the total count and the residency equal to the JAX package's."""
        v, k = 12, 3
        rng = np.random.default_rng(seed)
        oracle, th, jh = _make(tmp_path, v=v, k=k,
                               hot=int(rng.integers(0, v + 2)), seed=3,
                               name=f"seeded-{seed}")
        total = oracle.sum()
        ops = [(int(rng.integers(0, 4)), 1000 * seed + i) for i in range(10)]
        _schedule(th, jh, oracle, v, k, ops)
        _assert_same(th, jh, oracle)
        assert th.to_dense().numpy().sum() == total

    def test_random_residency_schedules_conserve_counts(self, tmp_path):
        pytest.importorskip("hypothesis")
        from hypothesis import given, settings, strategies as st

        v, k = 12, 3

        @settings(max_examples=25, deadline=None)
        @given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 2**16)),
                        min_size=1, max_size=8),
               st.integers(0, v + 1))
        def run(schedule, hot):
            oracle, th, jh = _make(tmp_path, v=v, k=k, hot=hot, seed=3,
                                   name=f"hyp-{hot}-{len(schedule)}")
            _schedule(th, jh, oracle, v, k, schedule)
            _assert_same(th, jh, oracle)

        run()


class TestSnapshotComposition:
    def test_publish_view_matches_dense_publish(self, tmp_path):
        """The frozen model published from a tiered view is bitwise the one
        published from the oracle dense table, and the JAX package's."""
        from repro.core import lightlda as jlda
        from repro.infer.snapshot import SnapshotPublisher as JPub
        from repro_torch.core import lightlda as tlda
        from repro_torch.infer.snapshot import SnapshotPublisher as TPub

        v, k = 30, 5
        oracle, th, jh = _make(tmp_path, v=v, k=k, hot=6)
        _push_both(th, jh, oracle, _reassign(v, k, 80, seed=11))
        th.refresh()
        jh.refresh()
        nk = oracle.sum(axis=0).astype(np.int32)
        client = tps.PSClient.create(num_shards=1)
        snap_tier = TPub(tlda.LDAConfig(num_topics=k, vocab_size=v)
                         ).publish_view(th.read_view(), client.wrap_vector(
                             torch.from_numpy(nk)))
        snap_dense = TPub(tlda.LDAConfig(num_topics=k, vocab_size=v)).publish(
            torch.from_numpy(oracle.astype(np.int32)), torch.from_numpy(nk))
        snap_jax = JPub(jlda.LDAConfig(num_topics=k, vocab_size=v)
                        ).publish_view(jh.read_view(), jps.PSClient.create(
                            num_shards=1).wrap_vector(jnp.asarray(nk)))
        assert torch.equal(snap_tier.phi, snap_dense.phi)
        assert torch.equal(snap_tier.model.nwk, snap_dense.model.nwk)
        np.testing.assert_array_equal(snap_tier.phi.numpy(),
                                      np.asarray(snap_jax.phi))


class TestHotTierSizing:
    def test_size_hot_rows_covers_target_mass(self):
        freq = np.array([100, 50, 20, 10, 5, 2, 1, 1], np.int64)
        h = t_size(freq, num_topics=4, target_mass=0.9, min_rows=1)
        assert freq[:h].sum() >= 0.9 * freq.sum()
        assert t_size(freq, 4, target_mass=0.9, min_rows=1,
                      budget_bytes=2 * 4 * 4) <= 2

    def test_sizing_and_retune_equal_jax_over_a_grid(self):
        rng = np.random.default_rng(0)
        for v in (1, 50, 3000):
            for freq in (np.zeros(v, np.int64),
                         np.sort(rng.zipf(1.3, v))[::-1].astype(np.int64)):
                for kw in (dict(), dict(target_mass=0.5, min_rows=1),
                           dict(budget_bytes=4096), dict(min_rows=5000)):
                    assert t_size(freq, 16, **kw) == j_size(freq, 16, **kw)
        for cur in (0, 1, 64, 800):
            for rate in (0.0, 0.5, 0.9, 1.0):
                for kw in (dict(vocab_size=1000), dict(vocab_size=50),
                           dict(vocab_size=1000, budget_bytes=4096,
                                num_topics=8)):
                    assert (t_retune(cur, rate, **kw)
                            == j_retune(cur, rate, **kw))
        assert t_retune(64, 0.5, vocab_size=1000) == 128
        assert t_retune(64, 0.95, vocab_size=1000) == 64
        assert t_retune(800, 0.1, vocab_size=1000) == 1000


@pytest.fixture(scope="module")
def corpora():
    args = (70, 250)
    kw = dict(true_topics=6, seed=5)
    return jcorpus(*args, **kw), tcorpus(*args, **kw)


TIERED_FITS = [dict(hot_rows=16, model_blocks=4),
               dict(hot_rows=None, model_blocks=3),
               dict(hot_rows=0, model_blocks=5, tier_refresh=0),
               dict(hot_rows=40, model_blocks=5, tier_refresh=2,
                    route=japi.HybridRoute(hot_words=25))]


class TestTieredEndToEnd:
    @pytest.mark.parametrize("kw", TIERED_FITS,
                             ids=["hot16", "auto-sized", "all-cold",
                                  "hybrid-refresh2"])
    def test_fit_matches_jax(self, corpora, tmp_path, kw):
        """A whole storage="tiered" fit: z, n_wk, n_k, n_dk and the tier's
        stats and residency bitwise, the cold-store files byte-equal,
        perplexities within rtol 1e-5."""
        jc, tc = corpora
        base = dict(num_topics=8, block_tokens=512, sweeps=3, eval_every=1,
                    seed=3, storage="tiered")
        jkw, tkw = dict(base, **kw), dict(base, **kw)
        if "route" in kw:
            tkw["route"] = tapi.HybridRoute(hot_words=25)
        jest = japi.APSLDA(japi.LDAJob(corpus=jc, tier_dir=str(
            tmp_path / "j"), **jkw), **QUIET)
        jm = jest.fit()
        test = tapi.APSLDA(tapi.LDAJob(corpus=tc, tier_dir=str(
            tmp_path / "t"), **tkw), device="cpu", **QUIET)
        tm = test.fit()
        np.testing.assert_array_equal(tm.nwk, np.asarray(jm.nwk))
        np.testing.assert_array_equal(tm.nk, np.asarray(jm.nk))
        ts, js = test.result_.state, jest.result_.state
        np.testing.assert_array_equal(ts.z.numpy(), np.asarray(js.z))
        np.testing.assert_array_equal(ts.ndk.numpy(), np.asarray(js.ndk))
        assert (ts.nwk.tier_stats().to_json()
                == js.nwk.tier_stats().to_json())
        np.testing.assert_array_equal(ts.nwk.tier.ids, js.nwk.tier.ids)
        assert _dir_bytes(str(tmp_path / "t")) == _dir_bytes(
            str(tmp_path / "j"))
        np.testing.assert_allclose([r["perplexity"] for r in tm.history],
                                   [r["perplexity"] for r in jm.history],
                                   rtol=1e-5)
        assert int(tm.nwk.sum()) == tc.num_tokens
        for key in ("mode", "n_blocks", "rows_per_block", "token_caps",
                    "hot_rows"):
            assert tm.info[key] == jm.info[key], key

    def test_fit_from_docs_conserves_tokens(self, tmp_path):
        rng = np.random.default_rng(0)
        docs = [rng.integers(0, 120, size=int(n))
                for n in rng.integers(20, 60, size=80)]
        job = dict(docs=docs, num_topics=8, storage="tiered", hot_rows=16,
                   model_blocks=4, sweeps=2, eval_every=0, seed=0)
        tm = tapi.APSLDA(tapi.LDAJob(tier_dir=str(tmp_path / "t"), **job),
                         device="cpu", **QUIET).fit()
        jm = japi.APSLDA(japi.LDAJob(tier_dir=str(tmp_path / "j"), **job),
                         **QUIET).fit()
        assert int(tm.nwk.sum()) == int(sum(d.size for d in docs))
        np.testing.assert_array_equal(tm.nwk, np.asarray(jm.nwk))

    def test_executor_step_matches_jax(self, corpora, tmp_path):
        """make_step exposes the tiered executor; two more sweeps from the
        fitted state stay bitwise with the JAX package's."""
        import jax
        from repro_torch import rng as trng

        jc, tc = corpora
        kw = dict(num_topics=8, block_tokens=512, sweeps=1, eval_every=0,
                  seed=4, storage="tiered", hot_rows=30, model_blocks=5)
        tst, tstep, tinfo = tapi.Session(tapi.LDAJob(
            corpus=tc, tier_dir=str(tmp_path / "t"), **kw), device="cpu",
            **QUIET).make_step()
        jst, jstep, jinfo = japi.Session(japi.LDAJob(
            corpus=jc, tier_dir=str(tmp_path / "j"), **kw),
            **QUIET).make_step()
        assert tinfo["mode"] == jinfo["mode"] == "tiered"
        for i in range(2):
            tst = tstep(tst, trng.PRNGKey(40 + i))
            jst = jstep(jst, jax.random.PRNGKey(40 + i))
        np.testing.assert_array_equal(tst.z.numpy(), np.asarray(jst.z))
        np.testing.assert_array_equal(tst.nwk.to_dense().numpy(),
                                      np.asarray(jst.nwk.to_dense()))

    def test_checkpoint_is_refused_with_the_reference_message(self, corpora):
        jc, tc = corpora
        problems = []
        for api, corp in ((japi, jc), (tapi, tc)):
            job = api.LDAJob(corpus=corp, storage="tiered", model_blocks=2,
                             checkpoint=api.CheckpointPolicy(path="x.npz"))
            problems.append(job.problems())
        assert problems[0] == problems[1]
        assert any("checkpointing tiered" in p for p in problems[1])

    @pytest.mark.parametrize("bad", [dict(storage="tiered"),
                                     dict(storage="lukewarm", model_blocks=2),
                                     dict(hot_rows=8, model_blocks=2),
                                     dict(storage="tiered", model_blocks=2,
                                          route="auto"),
                                     dict(storage="tiered", model_blocks=2,
                                          hot_rows=-1, tier_refresh=-1)])
    def test_job_validation_rejects_bad_tiered_knobs(self, bad):
        docs = [np.array([0, 1, 2])]
        with pytest.raises(japi.JobValidationError) as je:
            japi.LDAJob(docs=docs, num_topics=4, **bad).validate()
        with pytest.raises(tapi.JobValidationError) as te:
            tapi.LDAJob(docs=docs, num_topics=4, **bad).validate()
        assert te.value.problems == je.value.problems


def test_client_tiered_factory(tmp_path):
    dense = np.arange(40, dtype=np.int32).reshape(10, 4)
    h = tps.PSClient.create(backend="tiered").tiered_matrix_from_dense(
        torch.from_numpy(dense), 3, str(tmp_path / "c"), device="cpu")
    assert isinstance(h.client.backend, tps.TieredBackend)
    assert h.tier.hot_rows == 3 and h.num_shards == 1
    np.testing.assert_array_equal(h.to_dense().numpy(), dense)
    np.testing.assert_array_equal(h.read_view().to_dense().numpy(), dense)
    with pytest.raises(ValueError, match="single-shard"):
        tps.PSClient.create(num_shards=2).tiered_matrix_from_dense(
            dense, 3, str(tmp_path / "d"), device="cpu")
    assert dataclasses.is_dataclass(h.tier_stats())
