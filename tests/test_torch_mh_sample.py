"""The MH chain: the port's plain chain is bitwise the JAX package's chain
and its Pallas kernel (interpret mode), in both modes, given the same
``MHRandoms``; the table-plus-index plain version equals the chain on
pre-gathered rows."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import alias as jalias
from repro.core import lightlda as jlda
from repro.kernels import ops as kops
from repro_torch.core import lightlda as tlda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _problem(k, seed, rows=40, docs=6, tokens=300, steps=2, training=False):
    """Tables + per-token indices + randoms, all numpy.  ``training`` makes
    the counts contain each token's z0 (the -dw correction's premise)."""
    rng = np.random.default_rng(seed)
    nwk = rng.integers(0, 30, (rows, k)).astype(np.float32)
    w = rng.integers(0, rows, tokens).astype(np.int32)
    d = rng.integers(0, docs, tokens).astype(np.int32)
    z0 = rng.integers(0, k, tokens).astype(np.int32)
    ndk = rng.integers(0, 5, (docs, k)).astype(np.int32)
    np.add.at(ndk, (d, z0), 1)
    if training:
        np.add.at(nwk, (w, z0), 1.0)
    nk = nwk.sum(0)
    phi = (nwk + 0.01) / (nk + rows * 0.01)
    table = jalias.build_alias_rows(jnp.asarray(phi))
    rand = (rng.random((steps, tokens)).astype(np.float32),
            rng.random((steps, tokens)).astype(np.float32),
            rng.integers(0, k, (steps, tokens)).astype(np.int32),
            rng.random((steps, tokens)).astype(np.float32))
    return dict(nwk=nwk, nk=nk, w=w, d=d, z0=z0, ndk=ndk, rand=rand,
                aprob=np.asarray(table.prob), aalias=np.asarray(table.alias))


def _cfgs(k, rows, steps):
    return (jlda.LDAConfig(num_topics=k, vocab_size=rows, mh_steps=steps),
            tlda.LDAConfig(num_topics=k, vocab_size=rows, mh_steps=steps))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("k", [7, 128, 130])
@pytest.mark.parametrize("frozen", [True, False])
def test_mh_chain_bitwise_vs_jax_and_pallas(k, frozen):
    p = _problem(k, seed=k + frozen, training=not frozen)
    jcfg, tcfg = _cfgs(k, 40, 2)
    w, d = p["w"], p["d"]
    rows = (p["nwk"][w], p["ndk"][d], p["nk"], p["aprob"][w], p["aalias"][w])

    want = np.asarray(jlda.mh_chain(
        jlda.MHRandoms(*map(jnp.asarray, p["rand"])), jnp.asarray(p["z0"]),
        *map(jnp.asarray, rows), jcfg, frozen=frozen))
    pallas = np.asarray(kops.mh_sample(
        jlda.MHRandoms(*map(jnp.asarray, p["rand"])), jnp.asarray(p["z0"]),
        *map(jnp.asarray, rows), jcfg, frozen=frozen, interpret=True))
    got = tlda.mh_chain(tlda.MHRandoms(*map(_t, p["rand"])), _t(p["z0"]),
                        *map(_t, rows), tcfg, frozen=frozen).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert (got != p["z0"]).mean() > 0.5         # the chain really moves


@pytest.mark.parametrize("frozen", [True, False])
def test_mh_sample_ref_equals_chain_on_gathered_rows(frozen):
    k = 11
    p = _problem(k, seed=3, rows=25, docs=4, tokens=200, steps=3)
    _, tcfg = _cfgs(k, 25, 3)
    rng = tlda.MHRandoms(*map(_t, p["rand"]))
    w, d = p["w"], p["d"]
    want = tlda.mh_chain(rng, _t(p["z0"]), _t(p["nwk"][w]), _t(p["ndk"][d]),
                         _t(p["nk"]), _t(p["aprob"][w]), _t(p["aalias"][w]),
                         tcfg, frozen=frozen)
    args = (rng, _t(p["z0"]), _t(w), _t(d), _t(p["nwk"]), _t(p["ndk"]),
            _t(p["nk"]), _t(p["aprob"]), _t(p["aalias"]), tcfg)
    got = tref.mh_sample_ref(*args, frozen=frozen)
    assert torch.equal(got, want)
    # on a CPU tensor the dispatcher runs exactly the plain version
    assert torch.equal(tops.mh_sample(*args, frozen=frozen), want)
    assert tops.launch_counts()["mh_sample"] == 0


def test_sample_tokens_frozen_is_frozen_mode():
    k = 9
    p = _problem(k, seed=5)
    _, tcfg = _cfgs(k, 40, 2)
    model = tlda.FrozenModel(_t(p["nwk"]), _t(p["nk"]), _t(p["aprob"]),
                             _t(p["aalias"]))
    rng = tlda.MHRandoms(*map(_t, p["rand"]))
    got = tlda.sample_tokens_frozen(model, rng, _t(p["z0"]), _t(p["w"]),
                                    _t(p["d"]), _t(p["ndk"]), tcfg)
    want = tref.mh_sample_ref(rng, _t(p["z0"]), _t(p["w"]), _t(p["d"]),
                              model.nwk, _t(p["ndk"]), model.nk, model.aprob,
                              model.aalias, tcfg, frozen=True)
    assert torch.equal(got, want)


def test_freeze_model_matches_jax():
    """φ and the alias tables' pmf of a frozen model match the JAX
    package's (the φ expression is elementwise IEEE: bitwise)."""
    from repro_torch.core import alias as talias
    rng = np.random.default_rng(8)
    nwk = rng.integers(0, 40, (30, 12)).astype(np.int32)
    nk = nwk.sum(0)
    jcfg, tcfg = _cfgs(12, 30, 2)
    want = jlda.freeze_model(jnp.asarray(nwk), jnp.asarray(nk), jcfg)
    got = tlda.freeze_model(_t(nwk), _t(nk), tcfg)
    np.testing.assert_array_equal(got.nwk.numpy(), np.asarray(want.nwk))
    np.testing.assert_array_equal(got.nk.numpy(), np.asarray(want.nk))
    np.testing.assert_allclose(
        talias.alias_pmf(talias.AliasTable(got.aprob, got.aalias)).numpy(),
        np.asarray(jalias.alias_pmf(jalias.AliasTable(want.aprob,
                                                      want.aalias))),
        rtol=3e-5, atol=3e-6)

