"""The port's out-of-core stream against the JAX package's: shard
directories byte-equal, each package reading the other's, the loader's
schedule, the stream random streams, and a streamed fit on the CPU in both
executor modes (``nwk``/``nk`` bitwise, every z file byte-equal,
perplexities within rtol 1e-5)."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.api import session as jsession
from repro.core import lightlda as jlda
from repro.data import corpus as jcorpus
from repro.data import stream as jstream
from repro.train import async_exec as jexec
from repro_torch import api as tapi
from repro_torch import rng as jrng
from repro_torch.api import session as tsession
from repro_torch.core import lightlda as tlda
from repro_torch.data import corpus as tcorpus
from repro_torch.data import stream as tstream
from repro_torch.train import async_exec as texec

QUIET = dict(log_fn=lambda *a: None)


def _cfgs(corp, k=8):
    kw = dict(num_topics=k, vocab_size=corp.vocab_size, block_tokens=256,
              num_shards=2)
    return jlda.LDAConfig(**kw), tlda.LDAConfig(**kw)


def _files(path):
    return sorted(f for f in os.listdir(path))


def _assert_dirs_equal(a, b, only=None):
    fa, fb = _files(a), _files(b)
    assert fa == fb
    for f in fa:
        if only is None or only in f:
            with open(os.path.join(a, f), "rb") as x, \
                    open(os.path.join(b, f), "rb") as y:
                assert x.read() == y.read(), f


# ---------------------------------------------------------------------------
# The corpus helpers the stream and the launchers use
# ---------------------------------------------------------------------------

def test_corpus_splits_match_jax(tiny_corpus):
    corp = tiny_corpus
    a, b = (jcorpus.train_heldout_split(corp, 0.2, seed=4),
            tcorpus.train_heldout_split(corp, 0.2, seed=4))
    for ja, ta in zip(a, b):
        for name in ("w", "d", "doc_start", "doc_len", "word_freq"):
            np.testing.assert_array_equal(getattr(ta, name),
                                          getattr(ja, name))
            assert getattr(ta, name).dtype == getattr(ja, name).dtype
        assert ta.vocab_size == ja.vocab_size
    for ja, ta in zip(jcorpus.fold_eval_split(a[1], seed=3),
                      tcorpus.fold_eval_split(b[1], seed=3)):
        np.testing.assert_array_equal(ta, ja)
    d = corp.d[::3]
    np.testing.assert_array_equal(tcorpus._compact_docs(d),
                                  jcorpus._compact_docs(d))
    for ja, ta in zip(jcorpus._offsets(d), tcorpus._offsets(d)):
        np.testing.assert_array_equal(ta, ja)
    docs = [corp.w[s:s + n] for s, n in zip(corp.doc_start[:20],
                                             corp.doc_len[:20])] + [[]]
    ja, ta = (jcorpus.corpus_from_docs(docs, vocab_size=400),
              tcorpus.corpus_from_docs(docs, vocab_size=400))
    for name in ("w", "d", "doc_start", "doc_len", "word_freq"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))


# ---------------------------------------------------------------------------
# The on-disk format is the contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens,doc_cap", [(1024, None), (700, 16)])
def test_shard_dirs_are_byte_equal(tiny_corpus, tmp_path, tokens, doc_cap):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    ja = jstream.write_sharded(a, tiny_corpus, tokens, doc_cap=doc_cap)
    tb = tstream.write_sharded(b, tiny_corpus, tokens, doc_cap=doc_cap)
    assert ja.to_json() == tb.to_json()
    assert len(_files(a)) == 2 + 4 * ja.num_shards
    _assert_dirs_equal(a, b)


def test_each_package_reads_the_others_dir(tiny_corpus, tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstream.write_sharded(a, tiny_corpus, 1024)
    tstream.write_sharded(b, tiny_corpus, 1024)
    for path, reader_cls, writer_cls in (
            (a, tstream.ShardedCorpusReader, jstream.ShardedCorpusReader),
            (b, jstream.ShardedCorpusReader, tstream.ShardedCorpusReader)):
        reader, writer = reader_cls(path), writer_cls(path)
        assert reader.meta.to_json() == writer.meta.to_json()
        np.testing.assert_array_equal(reader.word_freq, writer.word_freq)
        for sid in range(reader.num_shards):
            z = np.random.default_rng(sid).integers(
                0, 8, reader.meta.tokens_per_shard, dtype=np.int32)
            writer.write_z(sid, z)
            got, want = reader.shard(sid), writer.shard(sid)
            for name in ("w", "d", "doc_start", "doc_len", "z"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))
            assert (got.n_tokens, got.n_docs) == (want.n_tokens,
                                                  want.n_docs)
            np.testing.assert_array_equal(reader.read_z(sid), z)
        for x, y in zip(tstream.rebuild_counts_from_stream(reader, 8),
                        jstream.rebuild_counts_from_stream(writer, 8)):
            np.testing.assert_array_equal(x, y)
    _assert_dirs_equal(a, b)


@pytest.mark.parametrize("seed,start,epochs", [
    (0, (0, 0), 3), (7, (1, 2), 3), (123, (2, 4), 4)])
@pytest.mark.parametrize("prefetch", [True, False])
def test_loader_schedule_matches_jax(stream_dir, seed, start, epochs,
                                     prefetch):
    path, jreader, _ = stream_dir
    jl = jstream.StreamingLoader(jreader, seed=seed, prefetch=prefetch,
                                 load_z=False)
    tl = tstream.StreamingLoader(tstream.ShardedCorpusReader(path),
                                 seed=seed, prefetch=prefetch, load_z=False)
    for e in range(epochs):
        np.testing.assert_array_equal(tl.order_for_epoch(e),
                                      jl.order_for_epoch(e))
    want = list(jl.iterate(jstream.Cursor(*start), epochs))
    got = list(tl.iterate(tstream.Cursor(*start), epochs))
    assert [(c.to_json(), s) for c, s, _ in got] == \
        [(c.to_json(), s) for c, s, _ in want]
    assert [(c.to_json(), s) for c, s in tl.schedule(
        tstream.Cursor(*start), epochs)] == \
        [(c.to_json(), s) for c, s, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        np.testing.assert_array_equal(g.w, w.w)
        assert g.z is None and w.z is None


def test_loader_memory_budget(stream_dir):
    path, jreader, _ = stream_dir
    reader = tstream.ShardedCorpusReader(path)
    need = 2 * reader.shard_nbytes(with_z=True)
    assert need == 2 * jreader.shard_nbytes(with_z=True)
    tstream.StreamingLoader(reader, memory_budget=need)      # exact fit
    with pytest.raises(ValueError, match="memory_budget"):
        tstream.StreamingLoader(reader, memory_budget=need - 1)
    tstream.StreamingLoader(reader, load_z=False,
                            memory_budget=2 * reader.shard_nbytes(False))


# ---------------------------------------------------------------------------
# Random streams and pass 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [(1024, 7), (262_144, 1000)])
def test_init_draw_matches_jax(shape, k):
    for seed, sid in ((0, 0), (5, 3), (2**31 + 9, 11)):
        want = np.asarray(jax.random.randint(
            jsession.stream_init_key(seed, sid), (shape,), 0, k,
            dtype=jnp.int32))
        got = tsession.stream_init_key(seed, sid)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsession.stream_init_key(seed, sid)))
        np.testing.assert_array_equal(jrng.randint(got, (shape,), 0,
                                                   k).numpy(), want)
    for seed, epoch, pos in ((0, 0, 0), (3, 2, 4), (9, 1, 17)):
        np.testing.assert_array_equal(
            tsession.stream_sweep_key(seed, epoch, pos).numpy(),
            np.asarray(jsession.stream_sweep_key(seed, epoch, pos)))


def test_init_stream_matches_jax(tiny_corpus, tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstream.write_sharded(a, tiny_corpus, 1024)
    tstream.write_sharded(b, tiny_corpus, 1024)
    jcfg, tcfg = _cfgs(tiny_corpus, k=7)
    jn, jk = jsession.init_stream(jstream.ShardedCorpusReader(a), jcfg,
                                  seed=4)
    tn, tk = tsession.init_stream(tstream.ShardedCorpusReader(b), tcfg,
                                  seed=4, device="cpu")
    np.testing.assert_array_equal(tn.value.numpy(), np.asarray(jn.value))
    np.testing.assert_array_equal(tk.value.numpy(), np.asarray(jk.value))
    assert tk.value.dtype == torch.int32
    _assert_dirs_equal(a, b)


# ---------------------------------------------------------------------------
# The streamed fit
# ---------------------------------------------------------------------------

MODES = {"snapshot": dict(staleness=1),
         "blocked": dict(staleness=1, model_blocks=4)}


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """The JAX package's 2-epoch streamed fit of the shared tiny corpus in
    each mode: (nwk, nk, perplexities, z files)."""
    corp = jcorpus.generate_lda_corpus(seed=0, num_docs=120, mean_doc_len=40,
                                       vocab_size=300, num_topics=6)
    out = {}
    for mode, kw in MODES.items():
        path = str(tmp_path_factory.mktemp("jax_" + mode))
        jstream.write_sharded(path, corp, tokens_per_shard=1024)
        reader = jstream.ShardedCorpusReader(path)
        jcfg, _ = _cfgs(corp)
        nwk, nk, hist, _ = jsession.stream_fit(
            reader, jcfg, jexec.ExecConfig(**kw), 2, seed=3, eval_every=3,
            **QUIET)
        out[mode] = (np.asarray(nwk.value), np.asarray(nk.value),
                     [r["perplexity"] for r in hist],
                     [reader.read_z(s) for s in range(reader.num_shards)])
    return out


def _check_against(jax_fit, nwk, nk, ppl, reader):
    jn, jk, jp, jz = jax_fit
    np.testing.assert_array_equal(nwk, jn)
    np.testing.assert_array_equal(nk, jk)
    np.testing.assert_allclose(ppl, jp, rtol=1e-5)
    assert len(ppl) == len(jp) == 3
    assert reader.num_shards == len(jz) == 5
    for sid, z in enumerate(jz):
        np.testing.assert_array_equal(reader.read_z(sid), z)


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_fit_matches_jax(jax_fits, stream_dir, mode):
    path, _, corp = stream_dir
    reader = tstream.ShardedCorpusReader(path)
    _, tcfg = _cfgs(corp)
    nwk, nk, hist, info = tsession.stream_fit(
        reader, tcfg, texec.ExecConfig(**MODES[mode]), 2, seed=3,
        eval_every=3, device="cpu", **QUIET)
    assert info["mode"] == mode and info["stream_shards"] == 5
    _check_against(jax_fits[mode], nwk.value.numpy(), nk.value.numpy(),
                   [r["perplexity"] for r in hist], reader)
    # the counts are the histogram of the persisted assignments
    hn, hk = tstream.rebuild_counts_from_stream(reader, tcfg.K)
    np.testing.assert_array_equal(nwk.to_dense().numpy(), hn)
    np.testing.assert_array_equal(nk.value.numpy(), hk)


@pytest.mark.parametrize("mode", list(MODES))
def test_session_streams_like_jax(jax_fits, stream_dir, mode):
    path, _, corp = stream_dir
    job = tapi.LDAJob(stream_dir=path, num_topics=8, block_tokens=256,
                      num_shards=2, epochs=2, seed=3, eval_every=3,
                      **MODES[mode])
    est = tapi.APSLDA(job, device="cpu", **QUIET)
    model = est.fit()
    res = est.result_
    assert res.state is None and res.reader is not None
    _check_against(jax_fits[mode], res.nwk.value.numpy(),
                   res.nk.value.numpy(),
                   [r["perplexity"] for r in model.history], res.reader)
    assert model.nwk.sum() == corp.num_tokens


def test_single_shard_blocked_equals_sweep_blocked_ref(tiny_corpus,
                                                       tmp_path):
    """A one-shard stream through the blocked executor at staleness 0
    equals the in-memory synchronous reference over several epochs."""
    corp = tiny_corpus
    _, cfg = _cfgs(corp)
    cap = -(-corp.num_tokens // 256) * 256
    path = str(tmp_path / "one")
    tstream.write_sharded(path, corp, tokens_per_shard=cap,
                          doc_cap=corp.num_docs)
    reader = tstream.ShardedCorpusReader(path)
    assert reader.num_shards == 1
    seed, epochs = 7, 2
    ec = texec.ExecConfig(staleness=0, model_blocks=4)
    nwk, nk, _, _ = tsession.stream_fit(reader, cfg, ec, epochs, seed=seed,
                                        device="cpu", **QUIET)

    sh = reader.shard(0, load_z=False)
    z0 = jrng.randint(tsession.stream_init_key(seed, 0), (cap,), 0, cfg.K)
    z0[sh.n_tokens:] = 0
    w, d = torch.from_numpy(sh.w.copy()), torch.from_numpy(sh.d.copy())
    valid = torch.arange(cap) < sh.n_tokens
    nwk0, nk0, ndk0 = tlda.rebuild_counts(w, d, z0, valid,
                                          reader.meta.doc_cap, cfg)
    state = tlda.SamplerState(w, d, z0, valid,
                              torch.from_numpy(sh.doc_start.copy()),
                              torch.from_numpy(sh.doc_len.copy()),
                              nwk0, nk0, ndk0)
    _, build_index, info = texec.make_stream_executor(cfg, ec, nwk0.layout)
    idx, bval = build_index(sh.w, valid.numpy())
    for epoch in range(epochs):
        key = tsession.stream_sweep_key(seed, epoch, 0)
        state = tlda.sweep_blocked_ref(state, key, cfg, idx, bval,
                                       info["rows_per_step"])
    assert torch.equal(state.nwk.value, nwk.value)
    assert torch.equal(state.nk.value, nk.value)
    np.testing.assert_array_equal(state.z.numpy(), reader.read_z(0))


def test_build_index_pinned_cap_and_overflow(stream_dir):
    path, jreader, corp = stream_dir
    jcfg, tcfg = _cfgs(corp)
    ec = dict(staleness=1, model_blocks=4)
    layout = tlda.rebuild_counts(torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.zeros(1, dtype=torch.int32),
                                 torch.ones(1, dtype=torch.bool), 1,
                                 tcfg)[0].layout
    _, tbuild, tinfo = texec.make_stream_executor(
        tcfg, texec.ExecConfig(**ec), layout)
    jlayout = jlda.rebuild_counts(jnp.zeros(1, jnp.int32),
                                  jnp.zeros(1, jnp.int32),
                                  jnp.zeros(1, jnp.int32),
                                  jnp.ones(1, bool), 1, jcfg)[0].layout
    _, jbuild, jinfo = jexec.make_stream_executor(
        jcfg, jexec.ExecConfig(**ec), jlayout)
    assert tinfo == jinfo
    sh = jreader.shard(0)
    valid = np.arange(sh.w.shape[0]) < sh.n_tokens
    for cap in (None, 4096):
        ti, tv = tbuild(sh.w, valid, cap=cap)
        ji, jv = jbuild(sh.w, valid, cap=cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ti.device.type == "cpu"
    assert ti.shape[1] == 4096
    # the coarse bucket: the hottest block's count rounded up to 2048
    assert tbuild(sh.w, valid)[0].shape[1] % 2048 == 0
    with pytest.raises(ValueError, match="overflows"):
        tbuild(sh.w, valid, cap=8)
    with pytest.raises(ValueError, match="overflows"):
        jbuild(sh.w, valid, cap=8)
