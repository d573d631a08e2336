"""Alias tables: the port's Vose build induces the JAX package's pmf (and
that of its Pallas kernel in interpret mode); alias draws are bitwise given
one table."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import alias as jalias
from repro.kernels import ops as kops
from repro_torch.core import alias as talias
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL, ATOL = 3e-5, 3e-6     # tests/test_kernels.py's alias-kernel tolerance


def _weights(v, k, seed):
    """Random rows plus the edge cases: a uniform row (every q exactly 1),
    exact-1.0 entries beside one small and one large, a near-one-hot row and
    an all-zero row."""
    rng = np.random.default_rng(seed)
    w = (rng.random((v, k)) ** 2 + 1e-5).astype(np.float32)
    w[0] = 1.0
    w[1] = 1.0
    w[1, 0], w[1, 1 % k] = 0.5, 1.5
    w[2] = 1e-6
    w[2, k // 3] = 1e3
    w[3] = 0.0
    return w


def _pmf_t(table):
    return talias.alias_pmf(table).numpy()


def _pmf_j(table):
    return np.asarray(jalias.alias_pmf(table))


@pytest.mark.parametrize("k", [1, 7, 128, 130])
def test_build_alias_rows_pmf_matches_jax(k):
    w = _weights(12, k, seed=k)
    got = talias.build_alias_rows(torch.from_numpy(w))
    want = jalias.build_alias_rows(jnp.asarray(w))
    np.testing.assert_allclose(_pmf_t(got), _pmf_j(want), rtol=RTOL,
                               atol=ATOL)
    # and both are the normalised weights
    norm = w / np.maximum(w.sum(1, keepdims=True), 1e-30)
    norm[3] = 1.0 / k                        # all-zero row: uniform
    np.testing.assert_allclose(_pmf_t(got), norm, rtol=1e-4, atol=1e-6)
    assert got.prob.dtype == torch.float32 and got.alias.dtype == torch.int32
    assert ((got.prob >= 0) & (got.prob <= 1)).all()
    assert ((got.alias >= 0) & (got.alias < k)).all()


@pytest.mark.parametrize("k", [7, 130])
def test_alias_table_matches_jax_bitwise_on_exact_rows(k):
    """Rows whose scaling is exact (the sum is k) go through the same stack
    order in both packages: identical tables, not only identical pmfs."""
    w = np.ones((3, k), np.float32)
    w[1, 0], w[1, 1] = 0.5, 1.5
    w[2, :4] = [0.25, 1.75, 0.5, 1.5]
    got = talias.build_alias_rows(torch.from_numpy(w))
    want = jalias.build_alias_rows(jnp.asarray(w))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))


@pytest.mark.parametrize("k", [7, 130])
def test_alias_sample_bitwise_given_one_table(k):
    w = _weights(10, k, seed=100 + k)
    table = jalias.build_alias_rows(jnp.asarray(w))
    rng = np.random.default_rng(k)
    rows = rng.integers(0, 10, 500)
    u = rng.random(500).astype(np.float32)
    u[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
    prob, alias = np.asarray(table.prob)[rows], np.asarray(table.alias)[rows]
    want = np.asarray(jalias.alias_sample(jnp.asarray(prob),
                                          jnp.asarray(alias), jnp.asarray(u)))
    got = talias.alias_sample(torch.from_numpy(prob), torch.from_numpy(alias),
                              torch.from_numpy(u)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v,k", [(16, 8), (37, 130)])
def test_alias_build_ref_matches_pallas_kernel(v, k):
    """The plain version behind the CUDA kernel induces the pmf of the TPU
    kernel it replaces (run as the JAX tests run it, in interpret mode)."""
    w = _weights(v, k, seed=v * k)
    want = kops.alias_build(jnp.asarray(w), tile_rows=16, interpret=True)
    got = tref.alias_build_ref(torch.from_numpy(w))
    np.testing.assert_allclose(_pmf_t(got), _pmf_j(want), rtol=RTOL,
                               atol=ATOL)


def test_alias_pmf_matches_jax():
    w = _weights(9, 33, seed=1)
    table = jalias.build_alias_rows(jnp.asarray(w))
    got = talias.alias_pmf(talias.AliasTable(
        torch.tensor(np.asarray(table.prob)),
        torch.tensor(np.asarray(table.alias))))
    np.testing.assert_allclose(got.numpy(), _pmf_j(table), rtol=1e-6,
                               atol=1e-7)


def test_ops_alias_build_on_cpu_is_the_plain_version():
    w = torch.from_numpy(_weights(8, 20, seed=2))
    got, want = tops.alias_build(w), tref.alias_build_ref(w)
    assert torch.equal(got.prob, want.prob)
    assert torch.equal(got.alias, want.alias)
    assert tops.launch_counts()["alias_build"] == 0



@pytest.mark.parametrize("v,k", [(400, 64), (300, 7), (300, 130),
                                 (100, 1000), (8, 1), (5, 33)])
def test_alias_table_of_training_weights_equals_jax_bitwise(v, k):
    """Training rebuilds its alias tables from (n_wk + β)/(n_k + Vβ) every
    sweep, so ``prob`` must equal the JAX package's to the last ulp, or an
    MH coin can flip.  That holds because ``row_sum`` adds in XLA's CPU
    order (windows of 32); ``p.sum(-1)`` differs in the last ulp in most
    rows, as the second half shows."""
    rng = np.random.default_rng(k)
    nwk = (rng.zipf(1.5, (v, k)) % 300).astype(np.float32)
    nk = nwk.sum(0) + 3
    w = ((nwk + np.float32(0.01))
         / (nk[None] + np.float32(v * 0.01))).astype(np.float32)
    got = talias.build_alias_rows(torch.from_numpy(w))
    want = jalias.build_alias_rows(jnp.asarray(w))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))
    xla = np.asarray(jax.jit(lambda x: x.sum(-1))(jnp.asarray(w)))
    np.testing.assert_array_equal(talias.row_sum(torch.from_numpy(w)).numpy(),
                                  xla)
    if k > 32:
        torch_order = torch.from_numpy(w).sum(-1).numpy()
        assert (torch_order != xla).any()
