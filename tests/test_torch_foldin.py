"""Fold-in: with a JAX FrozenModel carried across, the port's θ is bitwise
the JAX package's for the same seeds (every op is integer or elementwise
IEEE fp32), on both of its paths (jnp chain and Pallas kernel)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import lightlda as jlda
from repro.infer import foldin as jfold
from repro_torch import convert
from repro_torch import rng as trng
from repro_torch.core import lightlda as tlda
from repro_torch.infer import foldin as tfold


def _models(k, v, mh_steps=2, seed=0):
    rng = np.random.default_rng(seed)
    nwk = rng.integers(0, 40, (v, k)).astype(np.int32)
    nwk[:, 0] += 200                            # one heavy topic
    jcfg = jlda.LDAConfig(num_topics=k, vocab_size=v, mh_steps=mh_steps)
    tcfg = tlda.LDAConfig(num_topics=k, vocab_size=v, mh_steps=mh_steps)
    jm = jlda.freeze_model(jnp.asarray(nwk), jnp.asarray(nwk.sum(0)), jcfg)
    tm = convert.frozen_model_from_arrays(*(np.asarray(x) for x in jm),
                                          device="cpu")
    return jm, tm, jcfg, tcfg


def _docs(v, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, v, n).astype(np.int32) for n in lengths]


def _bits(x):
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("k,v,mh_steps,lengths,length,sweeps,burnin", [
    (7, 50, 2, (5, 17, 30, 1, 0), 32, 6, 2),
    (130, 60, 3, (40, 3), 48, 7, 2),      # 5 samples: not a power of two
])
def test_fold_in_batch_bitwise_vs_jax(k, v, mh_steps, lengths, length,
                                      sweeps, burnin):
    jm, tm, jcfg, tcfg = _models(k, v, mh_steps)
    docs = _docs(v, lengths, seed=k)
    seeds = [10 + i for i in range(len(docs))]
    w, valid = tfold.pack_docs(docs, length)
    fj = jfold.FoldInConfig(num_sweeps=sweeps, burnin=burnin)
    ft = tfold.FoldInConfig(num_sweeps=sweeps, burnin=burnin)
    want = jfold.fold_in_batch(
        jm, jnp.asarray(w), jnp.asarray(valid),
        jnp.stack([jax.random.PRNGKey(s) for s in seeds]), jcfg, fj)
    got = tfold.fold_in_batch(tm, torch.from_numpy(w),
                              torch.from_numpy(valid),
                              trng.keys_from_seeds(seeds), tcfg, ft)
    assert got.dtype == torch.float32 and got.shape == (len(docs), k)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)


def test_fold_in_docs_bitwise_vs_jax_kernel_path():
    """The JAX package's Pallas path (interpret mode) gives the same θ as its
    jnp path, and so the same θ as the port."""
    jm, tm, jcfg, tcfg = _models(9, 40, seed=2)
    docs = _docs(40, (12, 20, 7), seed=3)
    want = jfold.fold_in_docs(
        jm, docs, jcfg, jfold.FoldInConfig(num_sweeps=4, burnin=1,
                                           use_kernels=True,
                                           kernel_interpret=True),
        seeds=[5, 6, 7], length=32)
    got = tfold.fold_in_docs(tm, docs, tcfg,
                             tfold.FoldInConfig(num_sweeps=4, burnin=1),
                             seeds=[5, 6, 7], length=32)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_pack_docs_matches_jax():
    docs = _docs(30, (0, 3, 40, 16), seed=1)
    for length in (16, 33):
        for a, b in zip(tfold.pack_docs(docs, length),
                        jfold.pack_docs(docs, length)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ndk_from_z_matches_jax():
    rng = np.random.default_rng(4)
    z = rng.integers(0, 11, (3, 20)).astype(np.int32)
    valid = rng.random((3, 20)) < 0.7
    want = np.asarray(jfold._ndk_from_z(jnp.asarray(z), jnp.asarray(valid),
                                        11))
    got = tfold._ndk_from_z(torch.from_numpy(z), torch.from_numpy(valid), 11)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_theta_is_batch_composition_independent():
    """A document's θ depends on (model, tokens, seed, L) only: alone, in
    another batch, or in another position, it is bit-identical."""
    _, tm, _, tcfg = _models(8, 45, seed=5)
    docs = _docs(45, (9, 30, 14, 2, 25), seed=6)
    seeds = [21, 22, 23, 24, 25]
    fcfg = tfold.FoldInConfig(num_sweeps=5, burnin=1)
    full = tfold.fold_in_docs(tm, docs, tcfg, fcfg, seeds=seeds, length=32)
    alone = tfold.fold_in_docs(tm, [docs[1]], tcfg, fcfg, seeds=[22],
                               length=32)
    rev = tfold.fold_in_docs(tm, docs[::-1], tcfg, fcfg, seeds=seeds[::-1],
                             length=32)
    np.testing.assert_array_equal(alone[0], full[1])
    np.testing.assert_array_equal(rev[::-1], full)
    # the seed matters
    other = tfold.fold_in_docs(tm, [docs[1]], tcfg, fcfg, seeds=[99],
                               length=32)
    assert not np.array_equal(other[0], full[1])


def test_fold_in_config_validates():
    with pytest.raises(ValueError):
        tfold.FoldInConfig(num_sweeps=3, burnin=3)
    with pytest.raises(ValueError):
        tfold.FoldInConfig(num_sweeps=3, burnin=-1)
