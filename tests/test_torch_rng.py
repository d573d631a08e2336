"""The port's threefry PRNG is bitwise jax.random (partitionable layout),
including the exact call chain fold-in draws its randomness through."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import lightlda as jlda
from repro.infer import foldin as jfold
from repro_torch import rng as trng
from repro_torch.core import lightlda as tlda
from repro_torch.infer import foldin as tfold

SEEDS = [0, 3, 12345, -1, 2 ** 31 - 1, 2 ** 32 - 1]
SHAPES = [(3,), (2, 5), (4, 3, 7)]


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_split(seed):
    jk, tk = jax.random.PRNGKey(seed), trng.PRNGKey(seed)
    np.testing.assert_array_equal(_u32(jk), tk.numpy())
    for data in (0, 7, 0x1d4, 2 ** 31 - 1):
        np.testing.assert_array_equal(_u32(jax.random.fold_in(jk, data)),
                                      trng.fold_in(tk, data).numpy())
    for num in (2, 3, 4, 9):
        np.testing.assert_array_equal(_u32(jax.random.split(jk, num)),
                                      trng.split(tk, num).numpy())


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bitwise(seed, shape):
    a = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    b = trng.uniform(trng.PRNGKey(seed), shape).numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert ((b >= 0) & (b < 1)).all()


@pytest.mark.parametrize("span", [(0, 7), (0, 1000), (0, 65536),
                                  (0, 100003), (-5, 9), (3, 3)])
@pytest.mark.parametrize("shape", SHAPES)
def test_randint_bitwise(span, shape):
    lo, hi = span
    for seed in SEEDS[:3]:
        a = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                          lo, hi, dtype=jnp.int32))
        b = trng.randint(trng.PRNGKey(seed), shape, lo, hi).numpy()
        assert b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_batched_keys_match_vmap():
    seeds = [5, 6, 70000]
    jks = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    tks = trng.keys_from_seeds(seeds)
    np.testing.assert_array_equal(_u32(jks), tks.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (2, 9)))(jks)),
        trng.uniform(tks, (2, 9)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.randint(
            k, (11,), 0, 13, dtype=jnp.int32))(jks)),
        trng.randint(tks, (11,), 0, 13).numpy())
    np.testing.assert_array_equal(
        _u32(jax.vmap(lambda k: jax.random.fold_in(k, 4))(jks)),
        trng.fold_in(tks, 4).numpy())
    nested = trng.split(trng.split(tks, 3), 2)          # [B, 3, 2, 2]
    want = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 2)))(
        jax.vmap(lambda k: jax.random.split(k, 3))(jks))
    np.testing.assert_array_equal(_u32(want), nested.numpy())


@pytest.mark.parametrize("k,mh_steps", [(7, 2), (130, 3)])
def test_foldin_call_chain(k, mh_steps):
    """foldin.py's init draw (fold_in 0x1d4 + randint) and a sweep's
    ``_doc_randoms`` (fold_in s, two splits, uniforms, randint, the token
    pick) are bitwise the port's, row by row."""
    b, l = 4, 24
    rng = np.random.default_rng(k)
    nd = np.array([0, 1, 13, l], np.int32)
    seeds = [11, 12, 13, 14]
    jcfg = jlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=mh_steps)
    tcfg = tlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=mh_steps)
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    tkeys = trng.keys_from_seeds(seeds)

    jz = jax.vmap(lambda kk: jax.random.randint(
        jax.random.fold_in(kk, 0x1d4), (l,), 0, k, dtype=jnp.int32))(jkeys)
    tz = trng.randint(trng.fold_in(tkeys, 0x1d4), (l,), 0, k)
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())

    z = rng.integers(0, k, (b, l)).astype(np.int32)
    for s in (0, 5):
        jsweep = jax.vmap(lambda kk: jax.random.fold_in(kk, s))(jkeys)
        want = jax.vmap(lambda kk, zr, n: jfold._doc_randoms(
            kk, zr, n, jcfg))(jsweep, jnp.asarray(z), jnp.asarray(nd))
        got = tfold._doc_randoms(trng.fold_in(tkeys, s), torch.from_numpy(z),
                                 torch.from_numpy(nd), tcfg)
        for a, g in zip(want, got):
            a = np.asarray(a)
            assert a.dtype == g.numpy().dtype
            np.testing.assert_array_equal(a, g.numpy())
