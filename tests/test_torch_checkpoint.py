"""The port's checkpoints against the JAX package's: ``save_lda`` /
``restore_lda`` rebuild counts bitwise, the flat-npz keys are the JAX
package's, stream checkpoint files restore in either package, a resume
checks its config, and a stop-and-resume -- in the port alone, and across
the packages (the JAX package stops, the port resumes) -- equals an
uninterrupted run bitwise."""
import shutil
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.api import session as jsession
from repro.core import lightlda as jlda
from repro.data import stream as jstream
from repro.train import async_exec as jexec
from repro.train import checkpoint as jckpt
from repro_torch import rng as jrng
from repro_torch.api import session as tsession
from repro_torch.core import lightlda as tlda
from repro_torch.data import stream as tstream
from repro_torch.train import async_exec as texec
from repro_torch.train import checkpoint as tckpt

QUIET = dict(log_fn=lambda *a: None)
MODES = {"snapshot": dict(staleness=0),
         "blocked": dict(staleness=1, model_blocks=4)}
META = {"vocab_size": 6, "num_topics": 2, "ps_shards": 1,
        "tokens_per_shard": 64, "stream_shards": 3}


def _cfg(corp, pkg=tlda, k=8):
    return pkg.LDAConfig(num_topics=k, vocab_size=corp.vocab_size,
                         block_tokens=256, num_shards=2)


def _trained_state(corp):
    cfg = _cfg(corp)
    state = tlda.init_state(jrng.PRNGKey(9), torch.from_numpy(corp.w),
                            torch.from_numpy(corp.d), corp.num_docs, cfg)
    key = jrng.PRNGKey(1)
    for _ in range(2):
        key, sub = jrng.split(key)
        state = texec.snapshot_sweep(state, sub, cfg)
    return cfg, state


class _Pair(NamedTuple):
    a: object
    b: object


def test_flat_keys_match_jax(tmp_path):
    tree = {"x": np.arange(3, dtype=np.int32),
            "p": _Pair(np.ones(2, np.float32),
                       [np.zeros(1, np.int32), (np.full(2, 7, np.int32),)]),
            "none": None}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    assert list(tckpt._flatten(tree)) == list(jckpt._flatten(jtree))
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save(tpath, tree)
    jckpt.save(jpath, jtree)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    like = {"x": torch.zeros(3, dtype=torch.int64),
            "p": _Pair(torch.zeros(2), [np.zeros(1, np.int32),
                                        (np.zeros(2, np.int32),)]),
            "none": None}
    got = tckpt.restore(jpath, like)
    assert got["x"].dtype == torch.int64
    assert got["x"].tolist() == [0, 1, 2]
    assert torch.equal(got["p"].a, torch.ones(2))
    np.testing.assert_array_equal(got["p"].b[1][0], [7, 7])
    assert got["none"] is None


def test_save_restore_lda_counts_bitwise(tiny_corpus, tmp_path):
    cfg, state = _trained_state(tiny_corpus)
    path = str(tmp_path / "lda.npz")
    tckpt.save_lda(path, state)
    got = tckpt.restore_lda(path, cfg, state.ndk.shape[0], device="cpu")
    for name in ("w", "d", "z", "valid", "doc_start", "doc_len", "ndk"):
        assert torch.equal(getattr(got, name), getattr(state, name)), name
    assert torch.equal(got.nwk.value, state.nwk.value)
    assert torch.equal(got.nk.value, state.nk.value)
    # the JAX package restores the same file to the same counts
    jgot = jckpt.restore_lda(path, _cfg(tiny_corpus, jlda),
                             state.ndk.shape[0])
    np.testing.assert_array_equal(np.asarray(jgot.nwk.value),
                                  state.nwk.value.numpy())
    np.testing.assert_array_equal(np.asarray(jgot.ndk), state.ndk.numpy())
    # and a file the JAX package wrote restores in the port
    jpath = str(tmp_path / "jlda.npz")
    jckpt.save_lda(jpath, jgot)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    back = tckpt.restore_lda(jpath, cfg, state.ndk.shape[0], device="cpu")
    assert torch.equal(back.nwk.value, state.nwk.value)


def test_stream_checkpoint_files_interoperate(tmp_path):
    nwk = np.arange(12, dtype=np.int32).reshape(6, 2)
    nk = np.array([3, 4], np.int32)
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_stream(tpath, torch.from_numpy(nwk), torch.from_numpy(nk),
                      tstream.Cursor(2, 5), seed=17, meta=META)
    jckpt.save_stream(jpath, jnp.asarray(nwk), jnp.asarray(nk),
                      jstream.Cursor(2, 5), seed=17, meta=META)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    for got in (jckpt.restore_stream(tpath), tckpt.restore_stream(jpath)):
        np.testing.assert_array_equal(got.nwk_phys, nwk)
        np.testing.assert_array_equal(got.nk, nk)
        assert (got.cursor.epoch, got.cursor.pos) == (2, 5)
        assert got.seed == 17 and got.meta == META
    assert isinstance(tckpt.restore_stream(jpath).cursor, tstream.Cursor)


def test_resume_validates_config(stream_dir, tmp_path):
    path, _, corp = stream_dir
    reader = tstream.ShardedCorpusReader(path)
    ck = str(tmp_path / "ck.npz")
    tsession.stream_fit(reader, _cfg(corp), texec.ExecConfig(), 1,
                        checkpoint_path=ck, max_shards=1, device="cpu",
                        **QUIET)
    with pytest.raises(ValueError, match="mismatch"):
        tsession.stream_fit(reader, _cfg(corp, k=10), texec.ExecConfig(), 1,
                            resume=True, checkpoint_path=ck, device="cpu",
                            **QUIET)


def test_resume_missing_checkpoint_raises(stream_dir, tmp_path):
    path, _, corp = stream_dir
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        tsession.stream_fit(tstream.ShardedCorpusReader(path), _cfg(corp),
                            texec.ExecConfig(), 1, resume=True,
                            checkpoint_path=str(tmp_path / "nope.npz"),
                            device="cpu", **QUIET)


def _two_dirs(corp, tmp_path, writer=tstream):
    pa, pb = str(tmp_path / "a"), str(tmp_path / "b")
    writer.write_sharded(pa, corp, tokens_per_shard=1024)
    shutil.copytree(pa, pb)
    return pa, pb


def _assert_same_run(nwa, nka, ra, nwb, nkb, rb):
    np.testing.assert_array_equal(nwa, nwb)
    np.testing.assert_array_equal(nka, nkb)
    for sid in range(ra.num_shards):
        np.testing.assert_array_equal(ra.read_z(sid), rb.read_z(sid))


@pytest.mark.parametrize("mode", list(MODES))
def test_stop_and_resume_equals_uninterrupted(tiny_corpus, tmp_path, mode):
    """2 epochs straight == 7 shard visits (mid epoch 1) + checkpoint +
    resume, bitwise: PS counts and every shard's persisted z."""
    cfg, ec = _cfg(tiny_corpus), texec.ExecConfig(**MODES[mode])
    pa, pb = _two_dirs(tiny_corpus, tmp_path)
    ra, rb = tstream.ShardedCorpusReader(pa), tstream.ShardedCorpusReader(pb)
    nwa, nka, _, _ = tsession.stream_fit(ra, cfg, ec, 2, seed=5,
                                         device="cpu", **QUIET)
    ck = str(tmp_path / "ck.npz")
    tsession.stream_fit(rb, cfg, ec, 2, seed=5, checkpoint_path=ck,
                        checkpoint_every=1, max_shards=7, device="cpu",
                        **QUIET)
    saved = tckpt.restore_stream(ck)
    assert (saved.cursor.epoch, saved.cursor.pos) == (1, 2)
    nwb, nkb, _, _ = tsession.stream_fit(rb, cfg, ec, 2, resume=True,
                                         checkpoint_path=ck, device="cpu",
                                         **QUIET)
    _assert_same_run(nwa.value.numpy(), nka.value.numpy(), ra,
                     nwb.value.numpy(), nkb.value.numpy(), rb)


@pytest.mark.parametrize("mode", list(MODES))
def test_cross_package_resume(tiny_corpus, tmp_path, mode):
    """The JAX package trains 7 shard visits and checkpoints; the port
    resumes on the same directory to the end of epoch 2; the result equals
    the JAX package's uninterrupted run bitwise."""
    jcfg, tcfg = _cfg(tiny_corpus, jlda), _cfg(tiny_corpus)
    pa, pb = _two_dirs(tiny_corpus, tmp_path, writer=jstream)
    ra, rb = jstream.ShardedCorpusReader(pa), jstream.ShardedCorpusReader(pb)
    jec = jexec.ExecConfig(**MODES[mode])
    nwa, nka, _, _ = jsession.stream_fit(ra, jcfg, jec, 2, seed=5, **QUIET)
    ck = str(tmp_path / "ck.npz")
    jsession.stream_fit(rb, jcfg, jec, 2, seed=5, checkpoint_path=ck,
                        max_shards=7, **QUIET)
    nwb, nkb, _, _ = tsession.stream_fit(
        tstream.ShardedCorpusReader(pb), tcfg,
        texec.ExecConfig(**MODES[mode]), 2, resume=True, checkpoint_path=ck,
        device="cpu", **QUIET)
    _assert_same_run(np.asarray(nwa.value), np.asarray(nka.value), ra,
                     nwb.value.numpy(), nkb.value.numpy(), rb)
    # the port's final checkpoint restores in the JAX package
    saved = jckpt.restore_stream(ck)
    assert (saved.cursor.epoch, saved.cursor.pos) == (2, 0)
    np.testing.assert_array_equal(saved.nwk_phys, np.asarray(nwa.value))
