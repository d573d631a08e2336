"""The parameter-server layer of the port against the JAX package's:
cyclic layout, the storage primitives, every push route and the client
handles, bitwise on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import ps as jps
from repro.core import pserver as jpserver
from repro_torch import ps as tps
from repro_torch.core import pserver as tpserver

V, K = 97, 6


def _dense(seed, v=V, k=K):
    return np.random.default_rng(seed).integers(0, 30, (v, k)).astype(
        np.int32)


def _batch(seed, n=64, v=V, k=K):
    rng = np.random.default_rng(seed)
    w = np.minimum(rng.zipf(1.4, n) - 1, v - 1).astype(np.int32)
    z0 = rng.integers(0, k, n).astype(np.int32)
    z1 = rng.integers(0, k, n).astype(np.int32)
    changed = rng.random(n) < 0.7
    return w, z0, z1, changed


def _jre(b):
    w, z0, z1, c = b
    return jps.Reassign(jnp.asarray(w), jnp.asarray(w), jnp.asarray(z0),
                        jnp.asarray(z1), jnp.asarray(c))


def _tre(b):
    w, z0, z1, c = (torch.from_numpy(x) for x in b)
    return tps.Reassign(w, w, z0, z1, c)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- storage layer ----------------------------------------------------------

@pytest.mark.parametrize("rows,shards", [(97, 1), (97, 4), (10, 3), (1, 2)])
def test_cyclic_layout_matches_jax(rows, shards):
    a = jpserver.CyclicLayout(rows, shards)
    b = tpserver.CyclicLayout(rows, shards)
    assert (a.rows_per_shard, a.pad_rows) == (b.rows_per_shard, b.pad_rows)
    np.testing.assert_array_equal(a.permutation(), b.permutation())
    ids = np.arange(rows)
    np.testing.assert_array_equal(np.asarray(a.to_physical(ids)),
                                  b.to_physical(torch.from_numpy(ids)).numpy())
    np.testing.assert_array_equal(b.to_logical(b.to_physical(ids)), ids)
    for blk in range(b.pad_rows // max(b.rows_per_shard, 1)):
        np.testing.assert_array_equal(a.block_rows(blk, b.rows_per_shard),
                                      b.block_rows(blk, b.rows_per_shard))


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_matrix_primitives_match_jax(shards):
    dense = _dense(1)
    jm = jpserver.DistributedMatrix.from_dense(jnp.asarray(dense), shards)
    tm = tpserver.DistributedMatrix.from_dense(torch.from_numpy(dense),
                                               shards)
    np.testing.assert_array_equal(np.asarray(jm.value), tm.value.numpy())
    rng = np.random.default_rng(shards)
    rows = rng.integers(0, V, 40).astype(np.int32)
    deltas = rng.integers(-3, 4, (40, K)).astype(np.int32)
    pre = rng.integers(-2, 3, (13, K)).astype(np.int32)
    full = rng.integers(-2, 3, (V, K)).astype(np.int32)
    sr = rng.integers(0, V, 200).astype(np.int32)
    sc = rng.integers(0, K, 200).astype(np.int32)
    sv = rng.integers(-1, 2, 200).astype(np.int32)
    pairs = [
        (jm.pull(jnp.asarray(rows)), tm.pull(torch.from_numpy(rows))),
        (jm.push(jnp.asarray(rows), jnp.asarray(deltas)).value,
         tm.push(torch.from_numpy(rows), torch.from_numpy(deltas)).value),
        (jm.push_prefix(jnp.asarray(pre)).value,
         tm.push_prefix(torch.from_numpy(pre)).value),
        (jm.push_dense(jnp.asarray(full)).value,
         tm.push_dense(torch.from_numpy(full)).value),
        (jm.push_sparse(jnp.asarray(sr), jnp.asarray(sc),
                        jnp.asarray(sv)).value,
         tm.push_sparse(*(torch.from_numpy(x) for x in (sr, sc, sv))).value),
        (jm.push_sparse(jnp.asarray(sr), jnp.asarray(sc), jnp.asarray(sv),
                        use_kernel=True, interpret=True).value,
         tm.push_sparse(*(torch.from_numpy(x) for x in (sr, sc, sv))).value),
        (jm.pull_block(1, 8), tm.pull_block(1, 8)),
        (jm.block_logical_rows(2, 8), tm.block_logical_rows(2, 8)),
        (jm.to_dense(), tm.to_dense()),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # functional: the matrix pushed to is unchanged
    np.testing.assert_array_equal(tm.to_dense().numpy(), dense)


def test_vector_and_delta_buffer_match_jax():
    nk = np.arange(K, dtype=np.int32) * 3
    idx = np.array([0, 2, 2, 5], np.int32)
    dv = np.array([1, -1, 4, 2], np.int32)
    jv = jpserver.DistributedVector(jnp.asarray(nk))
    tv = tpserver.DistributedVector(torch.from_numpy(nk))
    np.testing.assert_array_equal(
        np.asarray(jv.push(jnp.asarray(idx), jnp.asarray(dv)).value),
        tv.push(torch.from_numpy(idx), torch.from_numpy(dv)).value.numpy())
    np.testing.assert_array_equal(
        np.asarray(jv.push_dense(jnp.asarray(nk)).value),
        tv.push_dense(torch.from_numpy(nk)).value.numpy())
    dense = _dense(4)
    rows = np.array([1, 1, 96, 3], np.int32)
    cols = np.array([0, 0, 5, 2], np.int32)
    jb = jpserver.DeltaBuffer.zeros(V, K).accumulate(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(dv))
    tb = tpserver.DeltaBuffer.zeros(V, K).accumulate(
        *(torch.from_numpy(x) for x in (rows, cols, dv)))
    np.testing.assert_array_equal(np.asarray(jb.delta), tb.delta.numpy())
    jm, jb2 = jb.flush(jpserver.DistributedMatrix.from_dense(
        jnp.asarray(dense), 2))
    tm, tb2 = tb.flush(tpserver.DistributedMatrix.from_dense(
        torch.from_numpy(dense), 2))
    np.testing.assert_array_equal(np.asarray(jm.value), tm.value.numpy())
    assert int(tb2.delta.abs().sum()) == 0


# --- routes -------------------------------------------------------------------

def _routes(pkg, v=V):
    return [pkg.DenseRoute(), pkg.CooRoute(), pkg.HybridRoute(hot_words=0),
            pkg.HybridRoute(hot_words=37), pkg.HybridRoute(hot_words=v)]


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("shards", [1, 3])
def test_every_route_gives_the_same_matrix_in_both_packages(i, shards):
    """Mirrors tests/test_ps.py::TestBackendParity in one process: adopt the
    counts, push every batch through the route, read the matrix back."""
    dense = _dense(7)
    batches = [_batch(20 + j) for j in range(3)]
    jh = jps.PSClient.create(num_shards=shards).matrix_from_dense(
        jnp.asarray(dense), route=_routes(jps)[i])
    th = tps.PSClient.create(num_shards=shards).matrix_from_dense(
        torch.from_numpy(dense), route=_routes(tps)[i])
    for b in batches:
        jh = jh.push(_jre(b))
        th = th.push(_tre(b))
    got = th.to_dense().numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.to_dense()))
    # and across routes: every route adds the same delta
    want = dense.astype(np.int64)
    for w, z0, z1, c in batches:
        np.add.at(want, (w[c], z0[c]), -1)
        np.add.at(want, (w[c], z1[c]), 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", range(5))
@pytest.mark.parametrize("prefix_rows", [False, True])
def test_route_plans_and_block_deltas_match_jax(i, prefix_rows):
    b = _batch(3, n=80)
    jr, tr = _routes(jps)[i], _routes(tps)[i]
    jp = jr.plan(_jre(b), V, K, prefix_rows=prefix_rows)
    tp = tr.plan(_tre(b), V, K, prefix_rows=prefix_rows)
    assert (jp.dense is None) == (tp.dense is None)
    assert (jp.coo is None) == (tp.coo is None)
    if tp.dense is not None:
        np.testing.assert_array_equal(np.asarray(jp.dense), tp.dense.numpy())
    if tp.coo is not None:
        for a, c in zip(jp.coo, tp.coo):
            np.testing.assert_array_equal(np.asarray(a), c.numpy())
    np.testing.assert_array_equal(
        np.asarray(jr.block_delta(_jre(b), V, K, prefix_rows=prefix_rows)),
        tr.block_delta(_tre(b), V, K, prefix_rows=prefix_rows).numpy())
    for hp in (None, 10):
        assert jr.traffic(80, V, K, hot_prefix=hp) == tr.traffic(
            80, V, K, hot_prefix=hp)
    assert jr.label == tr.label


@pytest.mark.parametrize("hot", [-1, 0, 1, V - 1, V, V + 1])
def test_hybrid_clamp_and_route_for_match_jax(hot):
    assert (jps.HybridRoute(hot_words=hot).clamped(V)
            == tps.HybridRoute(hot_words=hot).clamped(V))
    assert (type(jps.route_for(hot, V)).__name__
            == type(tps.route_for(hot, V)).__name__)
    b = _batch(hot + 5)
    jh = jps.PSClient.create().matrix_from_dense(
        jnp.asarray(_dense(2)), route=jps.HybridRoute(hot_words=hot))
    th = tps.PSClient.create().matrix_from_dense(
        torch.from_numpy(_dense(2)), route=tps.HybridRoute(hot_words=hot))
    np.testing.assert_array_equal(np.asarray(jh.push(_jre(b)).to_dense()),
                                  th.push(_tre(b)).to_dense().numpy())


def test_partitioned_push_matches_jax():
    hot = 9
    b = _batch(11, n=70)
    jre, jhp = jps.partition_reassign(_jre(b), hot)
    tre, thp = tps.partition_reassign(_tre(b), hot)
    assert jhp == thp
    for a, c in zip(jre, tre):
        np.testing.assert_array_equal(np.asarray(a), c.numpy())
    route_j, route_t = jps.HybridRoute(hot_words=hot), tps.HybridRoute(
        hot_words=hot)
    jh = jps.PSClient.create(num_shards=2).matrix_from_dense(
        jnp.asarray(_dense(5)), route=route_j).push(jre, hot_prefix=jhp)
    th = tps.PSClient.create(num_shards=2).matrix_from_dense(
        torch.from_numpy(_dense(5)), route=route_t).push(tre, hot_prefix=thp)
    np.testing.assert_array_equal(np.asarray(jh.to_dense()),
                                  th.to_dense().numpy())


# --- client handles -----------------------------------------------------------

def test_push_coo_masks_padded_rows_like_jax():
    """Rows >= num_rows alias a real row under the cyclic map; the client
    turns them into no-ops."""
    shards = 4
    dense = _dense(9, v=10)
    rows = np.array([0, 10, 11, 3, 9], np.int32)
    cols = np.array([1, 2, 3, 0, 5], np.int32)
    vals = np.array([1, 5, 7, -1, 2], np.int32)
    jh = jps.PSClient.create(num_shards=shards).matrix_from_dense(
        jnp.asarray(dense)).push_coo(jnp.asarray(rows), jnp.asarray(cols),
                                     jnp.asarray(vals))
    th = tps.PSClient.create(num_shards=shards).matrix_from_dense(
        torch.from_numpy(dense)).push_coo(
        *(torch.from_numpy(x) for x in (rows, cols, vals)))
    np.testing.assert_array_equal(np.asarray(jh.value), th.value.numpy())
    want = dense.astype(np.int64)
    np.add.at(want, (rows[rows < 10], cols[rows < 10]), vals[rows < 10])
    np.testing.assert_array_equal(th.to_dense().numpy(), want)


def test_handles_pull_copies_and_store_block_variants():
    client = tps.PSClient.create(num_shards=2)
    h = client.matrix_from_dense(torch.from_numpy(_dense(6)))
    fut = h.pull_block(1, 7)
    rows = fut.result()
    rows += 100                                    # a copy, not a view
    assert int(h.value[7:14].max()) < 100
    new = h.store_block(1, rows, 7)                # functional
    assert int(h.value[7:14].max()) < 100
    assert torch.equal(new.value[7:14], rows)
    same = h.store_block_(1, rows, 7)              # in place
    assert same is h and torch.equal(h.value[7:14], rows)
    nk = client.wrap_vector(torch.arange(K, dtype=torch.int32))
    assert torch.equal(nk.push_dense(torch.ones(K, dtype=torch.int32)).value,
                       torch.arange(1, K + 1, dtype=torch.int32))
    view = h.read_view()
    assert torch.equal(view.to_dense(), h.to_dense())
    with pytest.raises(TypeError, match="read-only"):
        view.push_coo(None, None, None)


def test_client_names_unported_backends():
    """SPMD is refused with its ROADMAP item; the tiered and network
    backends are ported: each client has the JAX package's backend (all
    four moments the identity), the net one detached without ``server``."""
    assert isinstance(tps.PSClient.create().backend, tps.InProcessBackend)
    assert isinstance(tps.InProcessBackend(), tps.Backend)
    with pytest.raises(tps.BackendConfigError, match="ROADMAP A, 'SPMD'"):
        tps.PSClient.create(backend="spmd")
    for name in ("tiered", "net"):
        tb = tps.PSClient.create(backend=name).backend
        jb = jps.PSClient.create(backend=name).backend
        assert type(tb).__name__ == type(jb).__name__
        assert isinstance(tb, tps.Backend)
        x = torch.arange(6, dtype=torch.int32)
        assert tb.reduce(x) is x and tb.gather_concat(x) is x
        assert (tb.axis_name, tb.model_axis) == (jb.axis_name, jb.model_axis)
    assert isinstance(tb, tps.NetBackend) and tb.net is None
    with pytest.raises(tps.BackendConfigError, match="unknown"):
        tps.PSClient.create(backend="carrier-pigeon")
    assert tps.BACKEND_NAMES == jps.BACKEND_NAMES


def test_matrix_factory_defaults_to_the_card():
    client = tps.PSClient.create()
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        client.matrix(4, 3)
    h = client.matrix(4, 3, device="cpu")
    assert h.value.shape == (4, 3) and h.value.device.type == "cpu"
    assert client.vector(3, device="cpu").value.dtype == torch.int32
