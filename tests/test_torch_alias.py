"""Alias tables: the port's Vose build induces the JAX package's pmf (and
that of its Pallas kernel in interpret mode) and equals its tables bitwise;
alias draws are bitwise given one table.  A numpy replay of the order the
CUDA kernel (``csrc/alias_build.cu``) retires entries in pins that order on
the CPU: it equals ``build_alias_rows`` bitwise."""
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


def _training_rows(v, k, seed):
    """(n_wk + β)/(n_k + Vβ) of Zipf counts, as the executors build it."""
    rng = np.random.default_rng(seed)
    nwk = (rng.zipf(1.5, (v, k)) % 300).astype(np.float32)
    nk = nwk.sum(0) + 3
    return ((nwk + np.float32(0.01))
            / (nk[None] + np.float32(v * 0.01))).astype(np.float32)


def _edge_rows(k, seed):
    """``chip_smoke.alias_test_weights``' rows: random, all q exactly 1,
    q == 1 beside one small and one large, near one-hot, all zero, one 1.0
    among 1e-6."""
    w = _weights(8, k, seed)
    w[4] = 1e-6
    w[4, 0] = 1.0
    return w


def _rows(kind, v, k):
    return _edge_rows(k, k) if kind == "edge" else _training_rows(v, k, k)


@pytest.mark.parametrize("kind,v,k", [
    *(pytest.param("training", v, k, id=f"{v}-{k}")
      for v, k in [(400, 64), (300, 7), (300, 130), (100, 1000), (8, 1),
                   (5, 33), (8, 7), (8, 130), (8, 1000), (8, 2000)]),
    *(pytest.param("edge", 8, k, id=f"edge-{k}")
      for k in (7, 130, 1000, 2000))])
def test_alias_table_of_training_weights_equals_jax_bitwise(kind, v, k):
    """Training rebuilds its alias tables from (n_wk + β)/(n_k + Vβ) every
    sweep, through ``ops.alias_build`` (the plain version on the CPU), so
    ``prob`` must equal the JAX package's to the last ulp, or an MH coin can
    flip.  That holds because ``row_sum`` adds in XLA's CPU order (windows
    of 32, twice past K = 1024); ``p.sum(-1)`` differs in the last ulp in
    most rows, as the second half shows.  The edge rows add q == 1, all-zero
    and near one-hot rows."""
    w = _rows(kind, v, k)
    got = tops.alias_build(torch.from_numpy(w))
    want = jalias.build_alias_rows(jnp.asarray(w))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(want.alias))
    xla = np.asarray(jax.jit(lambda x: x.sum(-1))(jnp.asarray(w)))
    np.testing.assert_array_equal(talias.row_sum(torch.from_numpy(w)).numpy(),
                                  xla)
    if kind == "training" and k > 32:
        torch_order = torch.from_numpy(w).sum(-1).numpy()
        assert (torch_order != xla).any()


# -- the CUDA kernel's order, replayed in numpy --------------------------------

def _xla_row_sum(w):
    """Row sums in XLA's CPU order: zero padding to a multiple of 32 split
    before/after, each window of 32 added left to right, again while more
    than 32 remain, the rest left to right (float32 throughout)."""
    x = w.astype(np.float32)
    while x.shape[1] > 32:
        n = x.shape[1]
        pad = (-n) % 32
        x = np.pad(x, ((0, 0), (pad // 2, pad - pad // 2)))
        win = x.reshape(x.shape[0], -1, 32)
        acc = np.zeros(win.shape[:2], np.float32)
        for i in range(32):
            acc = (acc + win[:, :, i]).astype(np.float32)
        x = acc
    acc = x[:, 0].copy()
    for i in range(1, x.shape[1]):
        acc = (acc + x[:, i]).astype(np.float32)
    return acc


def _replay_b2(w):
    """The kernel's construction: q = w * (K / sum); larges (not q < 1: NaN
    and q == 1 included) taken from the top index down, smalls the same
    way, a large whose residual falls below 1 retired next; each step
    alias[s] = l and q_l = (q_l + q_s) - 1.  Entries never retired keep
    prob 1 and alias themselves."""
    v, k = w.shape
    psum = np.maximum(_xla_row_sum(w), np.float32(1e-30))
    q = (w * (np.float32(k) / psum)[:, None]).astype(np.float32)
    prob = np.ones((v, k), np.float32)
    alias = np.tile(np.arange(k, dtype=np.int32), (v, 1))
    one = np.float32(1.0)
    for r in range(v):
        small = q[r] < one
        larges = iter(np.flatnonzero(~small)[::-1])
        smalls = iter(np.flatnonzero(small)[::-1])
        l, s = next(larges, None), next(smalls, None)
        if l is None or s is None:
            continue
        ql, qs = q[r, l], q[r, s]
        while True:
            prob[r, s], alias[r, s] = qs, l
            ql = np.float32(np.float32(ql + qs) - one)
            if ql < one:                     # l demoted: retired next
                s, qs = l, ql
                l = next(larges, None)
                if l is None:
                    prob[r, s] = one         # never retired
                    break
                ql = q[r, l]
            else:
                s = next(smalls, None)
                if s is None:
                    break
                qs = q[r, s]
    return np.clip(prob, 0.0, 1.0), alias


@pytest.mark.parametrize("kind", ["edge", "training"])
@pytest.mark.parametrize("k", [1, 7, 33, 130, 1000, 2000])
def test_kernel_order_replay_equals_build_alias_rows(k, kind):
    w = _rows(kind, 8, k)
    prob, alias = _replay_b2(w)
    want = talias.build_alias_rows(torch.from_numpy(w))
    np.testing.assert_array_equal(prob, want.prob.numpy())
    np.testing.assert_array_equal(alias, want.alias.numpy())
    np.testing.assert_array_equal(
        _xla_row_sum(w), talias.row_sum(torch.from_numpy(w)).numpy())

