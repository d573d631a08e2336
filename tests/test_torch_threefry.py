"""The key derivations and the init draws of the LDA paths: ``ops.split``,
``ops.fold_in`` and ``ops.randint`` against ``jax.random``, and a replay of
the CUDA kernels that take them on the card.

  * on CPU tensors (the plain versions, ``kernels.ref.threefry_keys_ref``
    and ``threefry_randint_ref``) the three equal ``jax.random.split``,
    ``fold_in`` and ``randint(..., dtype=int32)`` bitwise, at the LDA
    paths' shapes: serving's [32 x 1024] init draw at K in {7, 130, 1000}
    (its ``fold_in(keys, 0x1d4)`` folded into the draw), a stream shard's
    262,144 tokens from ``stream_init_key``, a snapshot sweep's
    ``split(key, 244)`` and the stream keys' fold-in chains;
  * a numpy uint32 replay of what one thread of ``threefry_keys_kernel``
    and of ``threefry_randint_kernel`` (``csrc/mh_draws.cu``) writes, at
    sampled (block, thread) pairs of the kernels' grids, equals the plain
    version.  On the card ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
    hold the kernels themselves to the plain versions.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro_torch import rng as trng
from repro_torch.api import session as tsess
from repro_torch.kernels import mh_draws as tdraws
from repro_torch.kernels import ops
from test_torch_draws import _bits, _child

KEY_THREADS, RAND_THREADS = 128, 256     # csrc/mh_draws.cu's block sizes


def _jkeys(seeds):
    return jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("k", [7, 130, 1000])
def test_foldin_init_draw_equals_jax(k):
    """Serving's init draw of a [32 x 1024] batch, one call."""
    seeds = range(1000, 1032)
    got = ops.randint(trng.keys_from_seeds(seeds), (1024,), 0, k,
                      fold_in=(0x1d4,))
    want = jax.vmap(lambda kk: jax.random.randint(
        jax.random.fold_in(kk, 0x1d4), (1024,), 0, k, dtype=jnp.int32))(
            _jkeys(seeds))
    assert got.dtype == torch.int32 and got.shape == (32, 1024)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_stream_init_draw_equals_jax():
    """A stream shard's init draw: 262,144 tokens from one key, the key
    ``stream_init_key``'s chain."""
    got = ops.randint(tsess.stream_init_key(3, 5), (262_144,), 0, 1000)
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 0), 5)
    want = jax.random.randint(jk, (262_144,), 0, 1000, dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("num", [2, 244])
def test_split_equals_jax(num):
    """A snapshot sweep's ``split(key, 244)``, a batch of keys split in
    two, and a single key's ``split(key)``."""
    key = trng.PRNGKey(11)
    np.testing.assert_array_equal(
        _np(jax.random.split(jax.random.PRNGKey(11), num)),
        ops.split(key, num).numpy())
    seeds = range(40, 72)
    got = ops.split(trng.keys_from_seeds(seeds), num)
    want = jax.vmap(lambda kk: jax.random.split(kk, num))(_jkeys(seeds))
    assert got.shape == (32, num, 2)
    np.testing.assert_array_equal(_np(want), got.numpy())


def test_fold_in_chains_equal_jax():
    """One datum, the stream keys' chains, and data past 2^31."""
    keys = trng.keys_from_seeds(range(32))
    jk = _jkeys(range(32))
    for data in ((0x1d4,), (1, 2, 3), (0, 7), (2 ** 32 - 1, 2 ** 31)):
        want = jk
        for x in data:
            want = jax.vmap(lambda kk, x=x: jax.random.fold_in(kk, x))(want)
        np.testing.assert_array_equal(_np(want),
                                      ops.fold_in(keys, *data).numpy())
    want = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(4), 1), 2), 9)
    np.testing.assert_array_equal(_np(want),
                                  tsess.stream_sweep_key(4, 2, 9).numpy())


def test_ops_route_to_the_plain_versions_on_cpu():
    keys = trng.keys_from_seeds(range(5))
    assert torch.equal(ops.split(keys, 3), trng.split(keys, 3))
    assert torch.equal(ops.fold_in(keys, 6, 1),
                       trng.fold_in(trng.fold_in(keys, 6), 1))
    assert torch.equal(ops.randint(keys, (3, 4), -5, 9),
                       trng.randint(keys, (3, 4), -5, 9))
    with pytest.raises(ValueError, match="datum"):
        ops.fold_in(keys)
    assert "threefry_keys" in ops.KERNELS and "threefry_randint" in ops.KERNELS


def test_wrappers_refuse_cpu_tensors_and_long_chains():
    keys = trng.keys_from_seeds(range(2))
    with pytest.raises(ValueError, match="CUDA"):
        tdraws.threefry_keys_cuda(keys, (), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tdraws.threefry_randint_cuda(keys, (4,), 0, 7)
    with pytest.raises(ValueError, match="at most"):
        tdraws._chain(range(tdraws.MAX_CHAIN + 1), "threefry_keys")
    arr, n = tdraws._chain((1, -1), "threefry_keys")
    assert n == 2 and list(arr) == [1, 0xFFFFFFFF]


# ---------------------------------------------------------------------------
# A numpy uint32 replay of one kernel thread.
# ---------------------------------------------------------------------------

def _chain(key, data):
    for x in data:
        key = _child(key, x & 0xFFFFFFFF)
    return key


def _keys_thread(block, t, keys, data, num):
    """What thread ``t`` of block ``block`` writes in ``threefry_keys``:
    ``(flat key index, key)``, or None past the output."""
    per = num if num else 1
    g = block * KEY_THREADS + t
    if g >= keys.shape[0] * per:
        return None
    b = g // per
    k = _chain(tuple(keys[b]), data)
    return g, (_child(k, g - b * per) if num else k)


def _randint_thread(block, t, keys, m, data, span, mult, minval):
    """What thread ``t`` of block ``block`` writes in ``threefry_randint``:
    ``(flat offset, value)``, or None past the sample shape.  Threads 0
    and 1 derive the block's split(key, 2) in its prologue."""
    tiles = -(-m // RAND_THREADS)
    b, n = block // tiles, (block % tiles) * RAND_THREADS + t
    if n >= m:
        return None
    k = _chain(tuple(keys[b]), data)
    hi, lo = _child(k, 0), _child(k, 1)
    off = ((_bits(hi, n) % np.uint32(span)) * np.uint32(mult)
           + _bits(lo, n) % np.uint32(span)) % np.uint32(span)
    # + minval modulo 2^32, read as int32 (the plain version's cast)
    v = np.array([off + np.uint32(minval & 0xFFFFFFFF)], np.uint32)
    return b * m + n, int(v.view(np.int32)[0])


@pytest.mark.parametrize("data,num", [((), 244), ((1, 4, 9), 0),
                                      ((0x1d4,), 3)])
def test_keys_kernel_replay_equals_plain(data, num):
    keys = trng.keys_from_seeds(range(7, 7 + 32)).numpy().astype(np.uint32)
    want = ops.fold_in(torch.from_numpy(keys.astype(np.int64)), *data) \
        if data else torch.from_numpy(keys.astype(np.int64))
    if num:
        want = ops.split(want, num)
    flat = want.reshape(-1, 2).numpy()
    total = 32 * (num or 1)
    blocks = -(-total // KEY_THREADS)
    rng = np.random.default_rng(num)
    picks = [(blocks - 1, KEY_THREADS - 1), (0, 0)]
    picks += [(int(a), int(b)) for a, b in
              zip(rng.integers(0, blocks, 40),
                  rng.integers(0, KEY_THREADS, 40))]
    hits = 0
    with np.errstate(over="ignore"):
        for block, t in picks:
            out = _keys_thread(block, t, keys, data, num)
            if out is None:
                continue
            g, (a, b) = out
            assert (int(a), int(b)) == tuple(flat[g]), (block, t)
            hits += 1
    assert hits > 10


@pytest.mark.parametrize("m,nkeys,lo,hi,data", [
    (1024, 32, 0, 1000, (0x1d4,)), (1000, 3, 0, 7, ()),
    (262_144, 1, 0, 130, (0, 5)), (300, 2, -5, 2 ** 31 - 1, ())])
def test_randint_kernel_replay_equals_plain(m, nkeys, lo, hi, data):
    keys = trng.keys_from_seeds(range(50, 50 + nkeys))
    want = ops.randint(keys, (m,), lo, hi, fold_in=data).reshape(-1).numpy()
    span = tdraws.randint_span(lo, hi)
    mult = tdraws.randint_mult(span)
    knp = keys.numpy().astype(np.uint32)
    tiles = -(-m // RAND_THREADS)
    rng = np.random.default_rng(m)
    picks = [(nkeys * tiles - 1, RAND_THREADS - 1), (0, 0)]
    picks += [(int(a), int(b)) for a, b in
              zip(rng.integers(0, nkeys * tiles, 40),
                  rng.integers(0, RAND_THREADS, 40))]
    hits = 0
    with np.errstate(over="ignore"):
        for block, t in picks:
            out = _randint_thread(block, t, knp, m, data, span, mult, lo)
            if out is None:
                continue
            o, v = out
            assert v == int(want[o]), (block, t)
            hits += 1
    assert hits > 10
