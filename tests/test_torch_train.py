"""The port's training path against the JAX package's: initialisation,
the chain's randoms, one sweep of each executor from the same state and
key (bitwise z and count tables), the synchronous blocked oracle, count
conservation at every staleness, a sweep never writing into the state
it was given, and the pipelined sweep's prefix path (a group of one
block works its valid slots alone) on a corpus whose tokens crowd into
one block and leave another empty."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from conftest import make_lda_state
from repro.core import lightlda as jlda
from repro.data import corpus as jcorpus
from repro.obs import exec_trace as jtrace
from repro.train import async_exec as jexec
from repro_torch import ps as tps
from repro_torch import rng as trng
from repro_torch.convert import sampler_state_from_arrays
from repro_torch.core import lightlda as tlda
from repro_torch.core.pserver import CyclicLayout
from repro_torch.obs import exec_trace
from repro_torch.train import async_exec as texec

sys.path.append(str(Path(__file__).resolve().parents[1]))
from chip_smoke import IdentityBackend  # noqa: E402


def _carry(state, cfg):
    """The port's copy of a JAX ``SamplerState``."""
    return sampler_state_from_arrays(
        *(np.asarray(x) for x in (state.w, state.d, state.z, state.valid,
                                  state.doc_start, state.doc_len,
                                  state.nwk.value, state.nk.value,
                                  state.ndk)),
        dataclasses.asdict(cfg), device="cpu")


def _assert_same(jst, tst):
    for name in ("z", "ndk", "w", "d", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jst, name)),
                                      getattr(tst, name).numpy(), name)
    np.testing.assert_array_equal(np.asarray(jst.nwk.value),
                                  tst.nwk.value.numpy())
    np.testing.assert_array_equal(np.asarray(jst.nk.value),
                                  tst.nk.value.numpy())


def _block_index(state, n_blocks):
    layout = state.nwk.layout
    rpb = layout.pad_rows // n_blocks
    assert rpb * n_blocks == layout.pad_rows
    idx, bval = tlda.block_token_index(state.w.numpy(), state.valid.numpy(),
                                       rpb, layout)
    return torch.from_numpy(idx), torch.from_numpy(bval), rpb


def _assert_conserved(state, cfg, n_tokens):
    """Every count table equals the histogram of z; token mass kept."""
    assert int(state.nk.value.sum()) == n_tokens
    assert int(state.nwk.to_dense().sum()) == n_tokens
    assert int(state.ndk.sum()) == n_tokens
    nwk, nk, ndk = tlda.rebuild_counts(state.w, state.d, state.z,
                                       state.valid, state.ndk.shape[0], cfg)
    assert torch.equal(nwk.value, state.nwk.value)
    assert torch.equal(nk.value, state.nk.value)
    assert torch.equal(ndk, state.ndk)
    z = state.z[state.valid]
    assert int(z.min()) >= 0 and int(z.max()) < cfg.K


@pytest.fixture(scope="module")
def carried():
    """(corpus, jax cfg, jax state, port state): V=300, K=8, ~4.7k tokens,
    two cyclic shards."""
    corp, cfg, jst = make_lda_state(seed=0)
    return corp, cfg, jst, _carry(jst, cfg)


def test_init_state_matches_jax(carried):
    corp, cfg, jst, _ = carried
    tcfg = tlda.LDAConfig(num_topics=cfg.K, vocab_size=cfg.V,
                          block_tokens=cfg.block_tokens,
                          num_shards=cfg.num_shards)
    tst = tlda.init_state(trng.PRNGKey(0), torch.from_numpy(corp.w),
                          torch.from_numpy(corp.d), corp.num_docs, tcfg)
    _assert_same(jst, tst)
    np.testing.assert_array_equal(np.asarray(jst.doc_start),
                                  tst.doc_start.numpy())
    np.testing.assert_array_equal(np.asarray(jst.doc_len),
                                  tst.doc_len.numpy())


def test_draw_mh_randoms_match_jax(carried):
    corp, cfg, jst, tst = carried
    b = 640
    d_b = jst.d[100:100 + b]
    jr = jlda.draw_mh_randoms(
        jax.random.PRNGKey(5),
        jlda.make_doc_draw(None, d_b, jst.z, jst.doc_start, jst.doc_len,
                           cfg), b, cfg)
    tr = tlda.draw_mh_randoms(
        trng.PRNGKey(5),
        tlda.make_doc_draw(tst.d[100:100 + b], tst.z, tst.doc_start,
                           tst.doc_len, cfg), b, cfg)
    for a, c in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())


SNAPSHOT_CASES = [(0, None), (1, None), (0, 37), (1, 0), (3, 64)]


@pytest.mark.parametrize("staleness,hot_words", SNAPSHOT_CASES)
def test_snapshot_sweep_matches_jax(carried, staleness, hot_words):
    corp, cfg, jst, tst = carried
    jout = jexec.snapshot_sweep(jst, jax.random.PRNGKey(7), cfg,
                                staleness=staleness, hot_words=hot_words)
    tout = texec.snapshot_sweep(tst, trng.PRNGKey(7), cfg,
                                staleness=staleness, hot_words=hot_words)
    _assert_same(jout, tout)


PIPELINED_CASES = [(0, None, 6), (1, None, 6), (0, 37, 6), (1, 37, 2),
                   (2, 0, 6)]


@pytest.mark.parametrize("staleness,hot_words,n_blocks", PIPELINED_CASES)
def test_pipelined_sweep_matches_jax(carried, staleness, hot_words,
                                     n_blocks):
    corp, cfg, jst, tst = carried
    idx, bval, rpb = _block_index(tst, n_blocks)
    jout = jexec.pipelined_sweep(jst, jax.random.PRNGKey(9), cfg,
                                 jnp.asarray(idx.numpy()),
                                 jnp.asarray(bval.numpy()), rpb,
                                 staleness=staleness, hot_words=hot_words)
    tout = texec.pipelined_sweep(tst, trng.PRNGKey(9), cfg, idx, bval, rpb,
                                 staleness=staleness, hot_words=hot_words)
    _assert_same(jout, tout)


def test_sweep_blocked_ref_matches_jax(carried):
    corp, cfg, jst, tst = carried
    idx, bval, rpb = _block_index(tst, 6)
    jout = jlda.sweep_blocked_ref(jst, jax.random.PRNGKey(3), cfg,
                                  jnp.asarray(idx.numpy()),
                                  jnp.asarray(bval.numpy()), rpb)
    tout = tlda.sweep_blocked_ref(tst, trng.PRNGKey(3), cfg, idx, bval, rpb)
    _assert_same(jout, tout)


@pytest.mark.parametrize("route", [None, tps.HybridRoute(hot_words=37),
                                   tps.CooRoute()])
def test_pipelined_staleness_zero_equals_its_own_oracle(carried, route):
    corp, cfg, jst, tst = carried
    idx, bval, rpb = _block_index(tst, 6)
    key = trng.PRNGKey(13)
    ref = tlda.sweep_blocked_ref(tst, key, cfg, idx, bval, rpb)
    got = tlda.sweep_blocked(tst, key, cfg, idx, bval, rpb, staleness=0,
                             route=route)
    for name in ("z", "ndk"):
        assert torch.equal(getattr(ref, name), getattr(got, name))
    assert torch.equal(ref.nwk.value, got.nwk.value)
    assert torch.equal(ref.nk.value, got.nk.value)


@pytest.mark.parametrize("staleness,hot_words", [
    (0, None), (1, None), (2, 50), (5, 0), (3, 300)])
def test_blocked_executor_conserves(carried, staleness, hot_words):
    corp, cfg, jst, tst = carried
    idx, bval, rpb = _block_index(tst, 6)
    key, state = trng.PRNGKey(1), tst
    for _ in range(2):
        key, sub = trng.split(key)
        state = texec.pipelined_sweep(state, sub, cfg, idx, bval, rpb,
                                      staleness=staleness,
                                      hot_words=hot_words)
        _assert_conserved(state, cfg, corp.num_tokens)


@pytest.mark.parametrize("staleness,hot_words", [(1, None), (3, 64),
                                                 (7, 0)])
def test_snapshot_executor_conserves(carried, staleness, hot_words):
    corp, cfg, jst, tst = carried
    key, state = trng.PRNGKey(2), tst
    for _ in range(2):
        key, sub = trng.split(key)
        state = tlda.sweep(state, sub, cfg, staleness=staleness,
                           hot_words=hot_words)
        _assert_conserved(state, cfg, corp.num_tokens)


def _snapshot_of(state):
    return {name: (t.value if hasattr(t, "value") else t).clone()
            for name, t in state._asdict().items()}


@pytest.mark.parametrize("blocked", [False, True])
def test_a_sweep_never_writes_into_its_input(carried, blocked):
    corp, cfg, jst, tst = carried
    before = _snapshot_of(tst)
    if blocked:
        idx, bval, rpb = _block_index(tst, 6)
        out = texec.pipelined_sweep(tst, trng.PRNGKey(4), cfg, idx, bval,
                                    rpb, staleness=1,
                                    route=tps.HybridRoute(hot_words=20))
    else:
        out = texec.snapshot_sweep(tst, trng.PRNGKey(4), cfg,
                                   route=tps.HybridRoute(hot_words=20))
    assert not torch.equal(out.z, tst.z)
    for name, t in _snapshot_of(tst).items():
        assert torch.equal(t, before[name]), name


def test_make_executor_matches_jax(carried):
    corp, cfg, jst, tst = carried
    for exec_kw in ({"staleness": 1, "hot_words": 37},
                    {"model_blocks": 4, "staleness": 1, "hot_words": 37}):
        jstep, jinfo = jexec.make_executor(jst, cfg,
                                           jexec.ExecConfig(**exec_kw))
        tstep, tinfo = texec.make_executor(tst, cfg,
                                           texec.ExecConfig(**exec_kw))
        for key in ("mode", "n_blocks", "rows_per_block", "staleness",
                    "group", "token_cap"):
            assert jinfo[key] == tinfo[key], key
        _assert_same(jstep(jst, jax.random.PRNGKey(8)),
                     tstep(tst, trng.PRNGKey(8)))


def test_exec_config_refuses_auto():
    """A concrete schedule cannot be built from "auto": only make_executor
    resolves it, and the message is the JAX package's, word for word."""
    for auto in (dict(route="auto"), dict(staleness="auto")):
        with pytest.raises(ValueError, match="make_executor") as je:
            jexec.ExecConfig(**auto).resolve_route(10)
        with pytest.raises(ValueError, match="make_executor") as te:
            texec.ExecConfig(**auto).resolve_route(10)
        assert str(te.value) == str(je.value)


def test_token_deltas_and_hybrid_count_deltas_match_jax(carried):
    corp, cfg, jst, tst = carried
    rng = np.random.default_rng(0)
    n = 500
    w = rng.integers(0, cfg.V, n).astype(np.int32)
    d = rng.integers(0, 20, n).astype(np.int32)
    z0 = rng.integers(0, cfg.K, n).astype(np.int32)
    z1 = rng.integers(0, cfg.K, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    for hot in (None, 0, 40):
        j = jexec.hybrid_count_deltas(*map(jnp.asarray, (w, d, z0, z1,
                                                         valid)), 20, hot,
                                      cfg)
        t = texec.hybrid_count_deltas(*map(torch.from_numpy, (w, d, z0, z1,
                                                              valid)), 20,
                                      hot, cfg)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _routed(state):
    """The same state, its n_wk handle on ``chip_smoke.IdentityBackend``:
    moments that are the identity, in a type that is not
    ``InProcessBackend``, so the executors take the routed merge."""
    client = state.nwk.client.with_backend(IdentityBackend())
    return state._replace(nwk=dataclasses.replace(state.nwk, client=client))


def test_merge_branch_follows_the_backend(carried):
    corp, cfg, jst, tst = carried
    assert texec.merges_in_one_launch(tst.nwk)
    assert not texec.merges_in_one_launch(_routed(tst).nwk)


@pytest.mark.parametrize("staleness,hot_words", [(0, None), (1, 37),
                                                 (3, 0)])
def test_snapshot_sweep_branches_match_jax(carried, staleness, hot_words):
    """The one-launch merge and the routed merge give the same sweep,
    bitwise, and both equal the JAX sweep."""
    corp, cfg, jst, tst = carried
    jout = jexec.snapshot_sweep(jst, jax.random.PRNGKey(17), cfg,
                                staleness=staleness, hot_words=hot_words)
    for st in (tst, _routed(tst)):
        tout = texec.snapshot_sweep(st, trng.PRNGKey(17), cfg,
                                    staleness=staleness, hot_words=hot_words)
        _assert_same(jout, tout)


@pytest.mark.parametrize("staleness,hot_words,n_blocks", [
    (0, None, 6), (1, 37, 6), (2, 0, 6)])
def test_pipelined_sweep_branches_match_jax(carried, staleness, hot_words,
                                            n_blocks):
    corp, cfg, jst, tst = carried
    idx, bval, rpb = _block_index(tst, n_blocks)
    jout = jexec.pipelined_sweep(jst, jax.random.PRNGKey(19), cfg,
                                 jnp.asarray(idx.numpy()),
                                 jnp.asarray(bval.numpy()), rpb,
                                 staleness=staleness, hot_words=hot_words)
    for st in (tst, _routed(tst)):
        tout = texec.pipelined_sweep(st, trng.PRNGKey(19), cfg, idx, bval,
                                     rpb, staleness=staleness,
                                     hot_words=hot_words)
        _assert_same(jout, tout)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("routed", [False, True])
def test_neither_merge_writes_into_the_input(carried, blocked, routed):
    """Both merge branches of both executors leave the state they were
    given as it was: n_wk's value, n_k, n_dk and z."""
    corp, cfg, jst, tst = carried
    st = _routed(tst) if routed else tst
    before = _snapshot_of(st)
    if blocked:
        idx, bval, rpb = _block_index(st, 6)
        out = texec.pipelined_sweep(st, trng.PRNGKey(6), cfg, idx, bval,
                                    rpb, staleness=1,
                                    route=tps.HybridRoute(hot_words=20))
    else:
        out = texec.snapshot_sweep(st, trng.PRNGKey(6), cfg,
                                   route=tps.HybridRoute(hot_words=20))
    assert not torch.equal(out.nk.value, st.nk.value)
    assert not torch.equal(out.ndk, st.ndk)
    for name, t in _snapshot_of(st).items():
        assert torch.equal(t, before[name]), name


SKEW_BLOCKS, EMPTY_BLOCK = 6, 3


@pytest.fixture(scope="module")
def skewed():
    """(jax cfg, jax state, port state) of ``carried``'s corpus with the
    words of physical block 3 (of 6) moved onto the rows of block 0: block
    0 then holds most of the tokens, block 3 none, as the index's groups
    are in a Zipf corpus (the hottest group's capacity, the rest mostly
    padding)."""
    corp = jcorpus.generate_lda_corpus(seed=0, num_docs=120, mean_doc_len=40,
                                       vocab_size=300, num_topics=6)
    cfg = jlda.LDAConfig(num_topics=8, vocab_size=300, block_tokens=512,
                         num_shards=2)
    layout = CyclicLayout(cfg.V, cfg.num_shards)
    rpb = layout.pad_rows // SKEW_BLOCKS
    phys = layout.to_physical(corp.w.astype(np.int64))
    moved = phys // rpb == EMPTY_BLOCK
    w = np.where(moved, layout.to_logical(phys - EMPTY_BLOCK * rpb),
                 corp.w).astype(corp.w.dtype)
    jst = jlda.init_state(jax.random.PRNGKey(0), jnp.asarray(w),
                          jnp.asarray(corp.d), corp.num_docs, cfg)
    return cfg, jst, _carry(jst, cfg)


SKEW_CASES = ["ref", "ref_routed", "jax", "jax_routed", "executor",
              "stream", "replay"]


@pytest.mark.parametrize("case", SKEW_CASES)
def test_prefix_path_is_exact_on_a_skewed_corpus(skewed, case):
    """At staleness 0 every group is one block, so the sweep works each
    group's valid prefix alone, its draws at the padded row's counters:
    bitwise the synchronous oracle and the JAX package's padded sweep,
    through the one-launch and the routed merge, ``make_executor``, the
    stream executor's step on its own index (capacity rounded to 2,048)
    and the trace replay; counts conserved.  The empty group draws,
    samples and merges no slot (on the card it launches none of
    ``mh_draws_train``, ``mh_sample`` and ``delta_push``:
    ``tests/test_torch_cuda.py``)."""
    cfg, jst, tst = skewed
    idx, bval, rpb = _block_index(tst, SKEW_BLOCKS)
    counts = bval.sum(1).tolist()
    assert counts[EMPTY_BLOCK] == 0 and counts[0] > sum(counts) / 2
    st = _routed(tst) if case.endswith("routed") else tst
    key, jkey = trng.PRNGKey(21), jax.random.PRNGKey(21)
    ec = dict(model_blocks=SKEW_BLOCKS, hot_words=37)
    if case.startswith("ref"):
        want = tlda.sweep_blocked_ref(tst, key, cfg, idx, bval, rpb)
        got = texec.pipelined_sweep(st, key, cfg, idx, bval, rpb,
                                    hot_words=37)
    elif case.startswith("jax"):
        want = jexec.pipelined_sweep(jst, jkey, cfg, jnp.asarray(idx.numpy()),
                                     jnp.asarray(bval.numpy()), rpb,
                                     hot_words=37)
        got = texec.pipelined_sweep(st, key, cfg, idx, bval, rpb,
                                    hot_words=37)
    elif case == "executor":
        jstep, _ = jexec.make_executor(jst, cfg, jexec.ExecConfig(**ec))
        tstep, info = texec.make_executor(tst, cfg, texec.ExecConfig(**ec))
        assert info["group"] == 1
        want, got = jstep(jst, jkey), tstep(tst, key)
    elif case == "stream":
        jstep, _, _ = jexec.make_stream_executor(
            cfg, jexec.ExecConfig(**ec), jst.nwk.layout)
        tstep, build, info = texec.make_stream_executor(
            cfg, texec.ExecConfig(**ec), tst.nwk.layout)
        sidx, sbval = build(tst.w.numpy(), tst.valid.numpy())
        assert sidx.shape[1] % 2048 == 0
        want = jstep(jst, jkey, jnp.asarray(sidx.numpy()),
                     jnp.asarray(sbval.numpy()))
        got = tstep(tst, key, sidx, sbval)
        _assert_same(tlda.sweep_blocked_ref(tst, key, cfg, sidx, sbval,
                                            info["rows_per_step"]), got)
    else:
        want = jtrace.traced_pipelined_sweep(jst, jkey, cfg,
                                             model_blocks=SKEW_BLOCKS)
        got = exec_trace.traced_pipelined_sweep(tst, key, cfg,
                                                model_blocks=SKEW_BLOCKS)
    _assert_same(want, got)
    _assert_conserved(got, cfg, sum(counts))
