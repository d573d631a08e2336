"""Count-delta aggregation: the port's plain versions of ``delta_push`` and
``delta_apply_coo`` against the JAX package's Pallas kernels (interpret
mode) and its oracles, bitwise -- out-of-range rows, value-0 padding and
duplicate coordinates included -- and the hybrid split helpers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import delta_push as jdelta
from repro.kernels import ops as kops
from repro.kernels import ref as jref
from repro_torch.kernels import delta_push as tdelta
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _tokens(v, k, n, seed, changed_frac=0.6, past=0):
    """A reassignment batch: Zipf-skewed rows (duplicates on the hot rows),
    ``past`` of them at or beyond ``v``."""
    rng = np.random.default_rng(seed)
    w = np.minimum(rng.zipf(1.3, n) - 1, v - 1).astype(np.int32)
    if past:
        w[rng.choice(n, past, replace=False)] = v + rng.integers(0, 9, past)
    z0 = rng.integers(0, k, n).astype(np.int32)
    z1 = rng.integers(0, k, n).astype(np.int32)
    changed = rng.random(n) < changed_frac
    return w, z0, z1, changed


def _coo(v, k, m, seed, past_rows=0, past_cols=0):
    """A COO buffer: repeated coordinates, values in [-3, 3], a quarter of
    them value-0 padding, and some rows/cols at or past the edge."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, v, m).astype(np.int32)
    c = rng.integers(0, k, m).astype(np.int32)
    r[m // 2: m // 2 + m // 8] = r[: m // 8]
    c[m // 2: m // 2 + m // 8] = c[: m // 8]
    vals = rng.integers(-3, 4, m).astype(np.int32)
    vals[rng.random(m) < 0.25] = 0
    if past_rows:
        r[rng.choice(m, past_rows, replace=False)] = v + 1
    if past_cols:
        c[rng.choice(m, past_cols, replace=False)] = k + 2
    return r, c, vals


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("v,k,n", [(37, 5, 300), (130, 16, 1500),
                                   (400, 7, 2048)])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_delta_push_matches_jax_kernel_and_oracle(v, k, n, frac):
    w, z0, z1, changed = _tokens(v, k, n, seed=v + n, changed_frac=frac)
    got = tops.delta_push(*_t(w, z0, z1, changed), v, k).numpy()
    kern = np.asarray(kops.delta_push(
        jnp.asarray(w), jnp.asarray(z0), jnp.asarray(z1),
        jnp.asarray(changed), v, k, interpret=True))
    oracle = np.asarray(jref.delta_push_ref(
        jnp.asarray(w), jnp.asarray(z0), jnp.asarray(z1),
        jnp.asarray(changed), v, k))
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, oracle)
    assert got.dtype == np.int32 and got.sum() == 0


def test_delta_push_drops_rows_past_the_matrix():
    """Rows >= num_rows, changed or not, add nothing -- as the TPU
    kernel's one-hot matches nothing there."""
    v, k, n = 60, 9, 1024
    w, z0, z1, changed = _tokens(v, k, n, seed=4, past=100)
    got = tops.delta_push(*_t(w, z0, z1, changed), v, k).numpy()
    kern = np.asarray(kops.delta_push(
        jnp.asarray(w), jnp.asarray(z0), jnp.asarray(z1),
        jnp.asarray(changed), v, k, interpret=True))
    np.testing.assert_array_equal(got, kern)
    keep = w < v
    want = np.zeros((v, k), np.int64)
    np.add.at(want, (w[keep & changed], z0[keep & changed]), -1)
    np.add.at(want, (w[keep & changed], z1[keep & changed]), 1)
    np.testing.assert_array_equal(got, want)


def test_delta_push_accumulates_into_a_given_table():
    v, k, n = 50, 6, 400
    w, z0, z1, changed = _tokens(v, k, n, seed=8)
    table = np.random.default_rng(1).integers(0, 20, (v, k)).astype(np.int32)
    out = torch.from_numpy(table.copy())
    got = tops.delta_push(*_t(w, z0, z1, changed), v, k, out=out)
    assert got is out
    np.testing.assert_array_equal(
        got.numpy(), table + tref.delta_push_ref(*_t(w, z0, z1, changed),
                                                 v, k).numpy())


@pytest.mark.parametrize("v,k,m", [(37, 5, 512), (300, 16, 4096)])
@pytest.mark.parametrize("past", [0, 20])
def test_delta_apply_coo_matches_jax_kernel_and_oracle(v, k, m, past):
    r, c, vals = _coo(v, k, m, seed=m + past, past_rows=past,
                      past_cols=past)
    got = tops.delta_apply_coo(*_t(r, c, vals), v, k).numpy()
    kern = np.asarray(kops.delta_apply_coo(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(vals), v, k,
        interpret=True))
    oracle = np.asarray(jref.delta_apply_coo_ref(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(vals), v, k))
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, oracle)


def test_delta_apply_coo_accumulates_in_place():
    v, k, m = 40, 8, 800
    r, c, vals = _coo(v, k, m, seed=3)
    base = np.arange(v * k, dtype=np.int32).reshape(v, k)
    out = torch.from_numpy(base.copy())
    tops.delta_apply_coo(*_t(r, c, vals), v, k, out=out)
    want = base.astype(np.int64)
    np.add.at(want, (r, c), vals)
    np.testing.assert_array_equal(out.numpy(), want)


def test_ops_refuse_a_mismatched_out():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        tops.delta_push(z, z, z, z.bool(), 3, 2,
                        out=torch.zeros((2, 2), dtype=torch.int32))


@pytest.mark.parametrize("hot", [0, 1, 11, 40])
def test_hybrid_helpers_match_jax(hot):
    v, k, n = 40, 6, 300
    w, z0, z1, changed = _tokens(v, k, n, seed=hot)
    th, tc = tdelta.split_hot_cold(*_t(w, changed), hot)
    jh, jc = jdelta.split_hot_cold(jnp.asarray(w), jnp.asarray(changed), hot)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    got = tdelta.cold_coo(*_t(w, z0, z1), tc)
    want = jdelta.cold_coo(jnp.asarray(w), jnp.asarray(z0), jnp.asarray(z1),
                           jc)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the hot dense part plus the cold COO part is the whole delta
    total = tops.delta_push(*_t(w, z0, z1), th, v, k)
    tops.delta_apply_coo(*got, v, k, out=total)
    np.testing.assert_array_equal(
        total.numpy(), tops.delta_push(*_t(w, z0, z1, changed), v,
                                       k).numpy())


def test_cuda_wrappers_refuse_cpu_tensors():
    z = torch.zeros(4, dtype=torch.int32)
    out = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdelta.delta_push_cuda(z, z, z, z.bool(), out)
    with pytest.raises(ValueError, match="CUDA"):
        tdelta.delta_apply_coo_cuda(z, z, z, out)


def _docs(n, num_docs, seed, past=0):
    """Doc ids in document order (runs of equal ids, as a group's tokens
    come), ``past`` of them at or beyond ``num_docs``."""
    rng = np.random.default_rng(seed)
    d = np.sort(rng.integers(0, num_docs, n)).astype(np.int32)
    if past:
        d[rng.choice(n, past, replace=False)] = num_docs + rng.integers(
            0, 5, past)
    return d


def _jax_merge(w, d, z0, z1, changed, v, k, num_docs, hot):
    """The JAX package's composition of one group's merge: the hybrid's hot
    half by its ``delta_push`` kernel (interpret mode), the cold half by
    ``cold_coo`` + its ``delta_apply_coo`` kernel, n_k and n_dk by
    ``token_deltas``.  Returns the (d_nwk [V, K], d_ndk, d_nk) deltas."""
    from repro.train import async_exec as jexec
    jw, jz0, jz1, jch = map(jnp.asarray, (w, z0, z1, changed))
    hot_m, cold_m = jdelta.split_hot_cold(jw, jch, hot)
    d_nwk = np.zeros((v, k), np.int32)
    if hot:
        d_nwk[:hot] += np.asarray(kops.delta_push(jw, jz0, jz1, hot_m, hot,
                                                  k, interpret=True))
    d_nwk += np.asarray(kops.delta_apply_coo(
        *jdelta.cold_coo(jw, jz0, jz1, cold_m), v, k, interpret=True))
    d_nk, d_ndk = jexec.token_deltas(jnp.asarray(d), jz0, jz1, jch,
                                     num_docs, k)
    return d_nwk, np.asarray(d_ndk), np.asarray(d_nk)


MERGE_CASES = [
    # (V, K, tokens, docs, changed fraction, rows past V, docs past D, H)
    (37, 5, 300, 9, 0.6, 0, 0, 11),
    (130, 16, 1500, 40, 0.5, 30, 25, 40),
    (400, 7, 2048, 64, 1.0, 50, 0, 100),
    (400, 7, 2048, 64, 0.0, 50, 40, 100),
    (300, 13, 1027, 20, 1.0, 0, 30, 0),
]


@pytest.mark.parametrize("v,k,n,num_docs,frac,past,past_docs,hot",
                         MERGE_CASES)
def test_merge_matches_jax_composition(v, k, n, num_docs, frac, past,
                                       past_docs, hot):
    """The merge form of ``delta_push`` (n_wk, n_dk and n_k at once, into
    given tables) equals the JAX package's routed composition bitwise:
    none-changed and all-changed batches, rows past V and docs past D
    included (each destination drops its own)."""
    w, z0, z1, changed = _tokens(v, k, n, seed=n + past, changed_frac=frac,
                                 past=past)
    d = _docs(n, num_docs, seed=n, past=past_docs)
    rng = np.random.default_rng(v)
    nwk = rng.integers(0, 50, (v, k)).astype(np.int32)
    ndk = rng.integers(0, 9, (num_docs, k)).astype(np.int32)
    nk = nwk.sum(0).astype(np.int32)
    out, ndk_out, nk_out = _t(nwk.copy(), ndk.copy(), nk.copy())
    got = tops.delta_push(*_t(w, z0, z1, changed), v, k, out=out,
                          docs=torch.from_numpy(d), ndk_out=ndk_out,
                          nk_out=nk_out)
    assert got is out
    d_nwk, d_ndk, d_nk = _jax_merge(w, d, z0, z1, changed, v, k, num_docs,
                                    hot)
    np.testing.assert_array_equal(out.numpy(), nwk + d_nwk)
    np.testing.assert_array_equal(ndk_out.numpy(), ndk + d_ndk)
    np.testing.assert_array_equal(nk_out.numpy(), nk + d_nk)
    if frac == 0.0:
        np.testing.assert_array_equal(out.numpy(), nwk)
        np.testing.assert_array_equal(nk_out.numpy(), nk)


def test_merge_destinations_are_independent():
    """Each destination is optional, and one destination's ranges never
    drop another's entries: a token whose row is past R still counts in
    n_dk and n_k."""
    v, k, n, num_docs = 50, 6, 600, 12
    w, z0, z1, changed = _tokens(v, k, n, seed=2, changed_frac=0.7, past=90)
    d = _docs(n, num_docs, seed=3, past=20)
    args = _t(w, z0, z1, changed)
    ndk = torch.zeros((num_docs, k), dtype=torch.int32)
    nk = torch.zeros(k, dtype=torch.int32)
    alone = tops.delta_push(*args, v, k)
    merged = tops.delta_push(*args, v, k, docs=torch.from_numpy(d),
                             ndk_out=ndk, nk_out=nk)
    assert torch.equal(alone, merged)
    keep = changed & (d < num_docs)
    want = np.zeros((num_docs, k), np.int64)
    np.add.at(want, (d[keep], z0[keep]), -1)
    np.add.at(want, (d[keep], z1[keep]), 1)
    np.testing.assert_array_equal(ndk.numpy(), want)
    want_nk = (np.bincount(z1[changed], minlength=k)
               - np.bincount(z0[changed], minlength=k))
    np.testing.assert_array_equal(nk.numpy(), want_nk)
    nk_only = torch.zeros(k, dtype=torch.int32)
    tops.delta_push(*args, v, k, nk_out=nk_only)
    assert torch.equal(nk_only, nk)
