"""The port's Spark-LDA baselines (EM and online VB, paper Table 1) against
the JAX package's: ``doc_term_matrix`` byte-equal; EM and online VB from
carried states (one step within float32 rounding, many steps within the
stated tolerances); the perplexities of their states; the shuffle model;
the port's own versions of ``tests/test_lda_baselines.py``; and the port's
init draws."""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import lda_em as jem
from repro.core import lda_online as jov
from repro.core import perplexity as jppl
from repro.data import corpus as jcorpus
from repro_torch import convert
from repro_torch import rng as trng
from repro_torch.core import lda_em as em
from repro_torch.core import lda_online as ov
from repro_torch.core import lightlda as lda
from repro_torch.core import perplexity as ppl
from repro_torch.data import corpus as corpus_mod

sys.path.append(str(Path(__file__).resolve().parents[1]))

# float32 rounding in another order (XLA's and PyTorch's digamma, exp and
# reductions differ in the last ulps; the port's EM adds its segment sums in
# float64, the JAX package's in float32): measured maxima 1.2e-6 (EM, 1
# iteration), 6.7e-5 (EM, 20), 2.1e-5 (online, 1 step), 1.5e-4 (online, 30)
EM_ONE, EM_MANY = 1e-5, 1e-4
ONLINE_ONE, ONLINE_MANY = 1e-4, 1e-3
PPL_RTOL = 1e-4


@pytest.fixture(scope="module")
def corp():
    return corpus_mod.generate_lda_corpus(
        seed=0, num_docs=200, mean_doc_len=50, vocab_size=300, num_topics=8)


@pytest.fixture(scope="module")
def tokens(corp):
    """(w, d, valid) for both packages."""
    valid = np.ones(corp.num_tokens, bool)
    return ((jnp.asarray(corp.w), jnp.asarray(corp.d), jnp.asarray(valid)),
            tuple(map(torch.from_numpy, (corp.w, corp.d, valid))))


def _close(got: torch.Tensor, want, rtol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=0, err_msg=what)


def test_doc_term_matrix_is_byte_equal(corp):
    jc = jcorpus.generate_lda_corpus(seed=0, num_docs=200, mean_doc_len=50,
                                     vocab_size=300, num_topics=8)
    docs = np.random.default_rng(0).choice(corp.num_docs, 32, replace=False)
    a = jcorpus.doc_term_matrix(jc, docs)
    b = corpus_mod.doc_term_matrix(corp, docs)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- EM -----------------------------------------------------------------------

def _em_pair(corp, tokens, k=10):
    jcfg = jem.EMConfig(num_topics=k, vocab_size=300)
    tcfg = em.EMConfig(num_topics=k, vocab_size=300)
    jst = jem.init_state(jax.random.PRNGKey(0), *tokens[0], corp.num_docs,
                         jcfg)
    tst = convert.em_state_from_arrays(*(np.asarray(x) for x in jst),
                                       device="cpu")
    return jcfg, tcfg, jst, tst


def _em_close(jst, tst, rtol):
    for name in ("gamma", "ndk", "nwk", "nk"):
        _close(getattr(tst, name), getattr(jst, name), rtol, name)


@pytest.mark.parametrize("iters,rtol", [(1, EM_ONE), (20, EM_MANY)])
def test_em_from_a_carried_state_matches_jax(corp, tokens, iters, rtol):
    jcfg, tcfg, jst, tst = _em_pair(corp, tokens)
    jst = jem.train(jst, *tokens[0], corp.num_docs, jcfg, iters)
    tst = em.train(tst, *tokens[1], corp.num_docs, tcfg, iters)
    _em_close(jst, tst, rtol)


def test_em_chunked_e_step_equals_one_chunk(corp, tokens, monkeypatch):
    """The E-step in many token chunks computes the same state as in one,
    bitwise on the CPU: each token reads only its own γ row and the old
    tables, and the segment sums add the chunks in token order."""
    _, tcfg, _, tst = _em_pair(corp, tokens)
    whole = em.em_iteration(em.EMState(*(x.clone() for x in tst)),
                            *tokens[1], corp.num_docs, tcfg)
    monkeypatch.setattr(em, "_CHUNK_ELEMS", 997 * tcfg.K)
    chunked = em.em_iteration(tst, *tokens[1], corp.num_docs, tcfg)
    for name in ("gamma", "ndk", "nwk", "nk"):
        assert torch.equal(getattr(chunked, name), getattr(whole, name))


def test_em_iteration_consumes_its_state(corp, tokens):
    """As documented: the new γ is written into the given state's γ, the
    count tables are new, and the given state's tables are left as they
    were."""
    _, tcfg, _, tst = _em_pair(corp, tokens)
    old = [x.clone() for x in tst]
    out = em.em_iteration(tst, *tokens[1], corp.num_docs, tcfg)
    assert out.gamma.data_ptr() == tst.gamma.data_ptr()
    assert torch.equal(tst.gamma, out.gamma)
    assert not torch.equal(tst.gamma, old[0])
    for name, before in zip(("ndk", "nwk", "nk"), old[1:]):
        assert getattr(out, name) is not getattr(tst, name)
        assert torch.equal(getattr(tst, name), before), name


def test_em_training_perplexity_matches_jax(corp, tokens):
    jcfg, tcfg, jst, tst = _em_pair(corp, tokens)
    jst = jem.train(jst, *tokens[0], corp.num_docs, jcfg, 5)
    tst = em.train(tst, *tokens[1], corp.num_docs, tcfg, 5)
    want = float(jppl.training_perplexity(*tokens[0], jst.ndk, jst.nwk,
                                          jst.nk, jcfg.alpha, jcfg.beta))
    got = float(ppl.training_perplexity(*tokens[1], tst.ndk, tst.nwk,
                                        tst.nk, tcfg.alpha, tcfg.beta))
    assert got == pytest.approx(want, rel=PPL_RTOL)


@pytest.mark.parametrize("k", [10, 20, 1000])
def test_shuffle_bytes_per_iter_is_exact(corp, k):
    assert (em.shuffle_bytes_per_iter(corp.num_tokens,
                                      em.EMConfig(k, 300))
            == jem.shuffle_bytes_per_iter(corp.num_tokens,
                                          jem.EMConfig(k, 300))
            == 2 * corp.num_tokens * k * 4)


def test_em_at_large_k_moves_to_its_symmetric_fixed_point_as_jax_does(
        corp, tokens):
    """From the Dirichlet(1) init EM at large K (here K = 400 on 10k
    tokens; on the card, K = 1,000 on 2M) does not break the topics'
    symmetry: both packages' perplexities rise toward the fixed point
    where every γ row is uniform, the smoothed unigram model
    (``chip_smoke.symmetric_perplexity``), and agree along the way.  The
    cause is held directly: γ's spread about 1/K (``chip_smoke.
    gamma_spread``) is wide after the init, narrower after one iteration
    yet not 0 (the E-step read the counts), and narrower still after 40,
    where every γ lies within 1/K of 1/K, in both packages alike."""
    from chip_smoke import (EM_MOVED, SYMMETRIC_SPREAD, gamma_spread,
                            symmetric_perplexity)

    k = 400
    jcfg, tcfg, jst, tst = _em_pair(corp, tokens, k=k)
    sym = symmetric_perplexity(corp, k, 300, tcfg.beta)

    def both(jst, tst):
        return (float(jppl.training_perplexity(*tokens[0], jst.ndk, jst.nwk,
                                               jst.nk, 0.1, 0.01)),
                float(ppl.training_perplexity(*tokens[1], tst.ndk, tst.nwk,
                                              tst.nk, 0.1, 0.01)))

    def spreads(jst, tst):
        return (gamma_spread(torch, torch.tensor(np.asarray(jst.gamma)),
                             tokens[1][2], k),
                gamma_spread(torch, tst.gamma, tokens[1][2], k))

    j0, t0 = both(jst, tst)
    s0 = spreads(jst, tst)
    jst = jem.em_iteration(jst, *tokens[0], corp.num_docs, jcfg)
    tst = em.em_iteration(tst, *tokens[1], corp.num_docs, tcfg)
    s1 = spreads(jst, tst)
    jst = jem.train(jst, *tokens[0], corp.num_docs, jcfg, 39)
    tst = em.train(tst, *tokens[1], corp.num_docs, tcfg, 39)
    s40 = spreads(jst, tst)
    j1, t1 = both(jst, tst)
    for a, b, c in zip(s0, s1, s40):
        assert EM_MOVED <= b < a and c < b and c <= SYMMETRIC_SPREAD
    assert s40[1] == pytest.approx(s40[0], rel=1e-2)
    assert t1 == pytest.approx(j1, rel=PPL_RTOL)
    for before, after in ((j0, j1), (t0, t1)):
        assert before < after < sym * (1 + 1e-4)
        # 40 iterations close 73 % of the distance (measured: 0.27 left)
        assert abs(after - sym) < 0.5 * abs(before - sym)


# -- online VB ----------------------------------------------------------------

def _batches(corp, n, batch_docs=32):
    rng = np.random.default_rng(0)
    return [corpus_mod.doc_term_matrix(
        corp, rng.choice(corp.num_docs, batch_docs, replace=False))
        for _ in range(n)]


def _online_pair(k=10):
    jcfg = jov.OnlineConfig(num_topics=k, vocab_size=300, batch_docs=32)
    tcfg = ov.OnlineConfig(num_topics=k, vocab_size=300, batch_docs=32)
    jst = jov.init_state(jax.random.PRNGKey(0), jcfg)
    tst = convert.online_state_from_arrays(np.asarray(jst.lam),
                                           np.asarray(jst.t), device="cpu")
    return jcfg, tcfg, jst, tst


def _online_run(corp, steps):
    jcfg, tcfg, jst, tst = _online_pair()
    mask = np.ones(jcfg.batch_docs, np.float32)
    for dw in _batches(corp, steps):
        jst = jov.online_step(jst, jnp.asarray(dw), jnp.asarray(mask),
                              corp.num_docs, jcfg)
        tst = ov.online_step(tst, torch.from_numpy(dw),
                             torch.from_numpy(mask), corp.num_docs, tcfg)
    return jcfg, tcfg, jst, tst


@pytest.mark.parametrize("steps,rtol", [(1, ONLINE_ONE),
                                        (30, ONLINE_MANY)])
def test_online_from_a_carried_lambda_matches_jax(corp, steps, rtol):
    _, _, jst, tst = _online_run(corp, steps)
    _close(tst.lam, jst.lam, rtol, "lambda")
    assert int(tst.t) == int(jst.t) == steps
    assert tst.t.dtype == torch.int32


def test_online_fold_in_perplexity_matches_jax(corp, tokens):
    jcfg, tcfg, jst, tst = _online_run(corp, 5)
    jphi = jov.phi_from_state(jst)
    tphi = ov.phi_from_state(tst)
    _close(tphi, jphi, ONLINE_ONE, "phi")
    jtheta = jppl.fold_in_theta(*tokens[0], jphi, corp.num_docs, jcfg.alpha)
    want = float(jnp.exp(-jppl.log_likelihood(*tokens[0], jtheta, jphi,
                                              corp.num_docs)
                         / corp.num_tokens))
    ttheta = ppl.fold_in_theta(*tokens[1], tphi, corp.num_docs, tcfg.alpha)
    got = float(torch.exp(-ppl.log_likelihood(*tokens[1], ttheta, tphi)
                          / corp.num_tokens))
    assert got == pytest.approx(want, rel=PPL_RTOL)


def test_fold_in_theta_chunked_equals_one_chunk(corp, tokens, monkeypatch):
    _, _, _, tst = _online_run(corp, 2)
    phi = ov.phi_from_state(tst)
    whole = ppl.fold_in_theta(*tokens[1], phi, corp.num_docs, 0.1)
    monkeypatch.setattr(ppl, "_CHUNK_ELEMS", 1009 * phi.shape[1])
    chunked = ppl.fold_in_theta(*tokens[1], phi, corp.num_docs, 0.1)
    assert torch.equal(chunked, whole)


# -- the init draws -------------------------------------------------------------

def test_em_init_draws_lie_on_the_simplex(corp, tokens):
    k = 10
    st = em.init_state(3, *tokens[1], corp.num_docs,
                       em.EMConfig(num_topics=k, vocab_size=300))
    g = st.gamma.double()
    torch.testing.assert_close(g.sum(-1), torch.ones(g.shape[0],
                                                     dtype=torch.float64),
                               rtol=0, atol=1e-6)
    assert (g >= 0).all()
    # Dirichlet(1): each component has mean 1/K, variance
    # (K - 1) / (K^2 (K + 1)); every column's mean within 4 standard errors
    se = np.sqrt((k - 1) / (k * k * (k + 1)) / g.shape[0])
    assert (g.mean(0) - 1.0 / k).abs().max() < 4 * se
    # the M-step's tables from the draw
    assert float(st.nk.sum()) == pytest.approx(corp.num_tokens, rel=1e-5)
    again = em.init_state(3, *tokens[1], corp.num_docs,
                          em.EMConfig(num_topics=k, vocab_size=300))
    assert torch.equal(again.gamma, st.gamma)


def test_online_init_draws_are_gamma_100_scaled(corp):
    cfg = ov.OnlineConfig(num_topics=40, vocab_size=3000)
    st = ov.init_state(5, cfg, device="cpu")
    lam = st.lam.double()
    assert st.lam.dtype == torch.float32 and tuple(lam.shape) == (40, 3000)
    assert int(st.t) == 0 and st.t.dtype == torch.int32
    # Gamma(100) x 0.01: mean 1, standard deviation 0.1
    se = 0.1 / np.sqrt(lam.numel())
    assert abs(float(lam.mean()) - 1.0) < 4 * se
    assert float(lam.std()) == pytest.approx(0.1, rel=0.02)
    assert (lam > 0).all()
    assert torch.equal(ov.init_state(5, cfg, device="cpu").lam, st.lam)


# -- the port's own tests/test_lda_baselines.py ---------------------------------

def test_em_responsibilities_normalised(corp, tokens):
    cfg = em.EMConfig(num_topics=10, vocab_size=300)
    st = em.init_state(0, *tokens[1], corp.num_docs, cfg)
    st = em.em_iteration(st, *tokens[1], corp.num_docs, cfg)
    torch.testing.assert_close(st.gamma.sum(-1),
                               torch.ones(corp.num_tokens), rtol=0,
                               atol=1e-4)
    # expected counts conserve token mass
    assert abs(float(st.nk.sum()) - corp.num_tokens) < 1.0


def _em_perplexity(tokens, st, cfg):
    return float(ppl.training_perplexity(*tokens[1], st.ndk, st.nwk, st.nk,
                                         cfg.alpha, cfg.beta))


def test_em_perplexity_decreases(corp, tokens):
    cfg = em.EMConfig(num_topics=10, vocab_size=300)
    st = em.init_state(0, *tokens[1], corp.num_docs, cfg)
    p0 = _em_perplexity(tokens, st, cfg)
    st = em.train(st, *tokens[1], corp.num_docs, cfg, 20)
    assert _em_perplexity(tokens, st, cfg) < p0 * 0.9


def test_em_shuffle_bytes_model(corp):
    cfg = em.EMConfig(num_topics=20, vocab_size=300)
    assert em.shuffle_bytes_per_iter(corp.num_tokens, cfg) == \
        2 * corp.num_tokens * 20 * 4


def test_online_perplexity_decreases(corp, tokens):
    cfg = ov.OnlineConfig(num_topics=10, vocab_size=300, batch_docs=32)
    st = ov.init_state(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    w, d, valid = tokens[1]

    def p(st):
        phi = ov.phi_from_state(st)
        theta = ppl.fold_in_theta(w, d, valid, phi, corp.num_docs,
                                  cfg.alpha)
        ll = ppl.log_likelihood(w, d, valid, theta, phi)
        return float(torch.exp(-ll / corp.num_tokens))

    p0 = p(st)
    for _ in range(30):
        docs = rng.choice(corp.num_docs, cfg.batch_docs, replace=False)
        dw = torch.from_numpy(corpus_mod.doc_term_matrix(corp, docs))
        st = ov.online_step(st, dw, torch.ones(cfg.batch_docs),
                            corp.num_docs, cfg)
    p1 = p(st)
    assert p1 < p0 * 0.9, (p0, p1)


def test_comparable_quality(corp, tokens):
    """Paper Table 1's central claim: the algorithms reach *roughly equal*
    perplexity on the same corpus (LightLDA through the port's sampler,
    EM through the port's baseline)."""
    k = 10
    w, d, valid = tokens[1]
    lcfg = lda.LDAConfig(num_topics=k, vocab_size=300, block_tokens=2048)
    ls = lda.init_state(trng.PRNGKey(0), w, d, corp.num_docs, lcfg)
    ls = lda.train(ls, trng.PRNGKey(1), lcfg, 40)
    p_light = float(ppl.training_perplexity(
        ls.w, ls.d, ls.valid, ls.ndk, ls.nwk.to_dense(), ls.nk.value,
        lcfg.alpha, lcfg.beta))

    ecfg = em.EMConfig(num_topics=k, vocab_size=300)
    es = em.init_state(0, w, d, valid, corp.num_docs, ecfg)
    es = em.train(es, w, d, valid, corp.num_docs, ecfg, 40)
    p_em = _em_perplexity(tokens, es, ecfg)

    # same ballpark (paper: within ~10% of each other across Table 1)
    assert abs(p_light - p_em) / min(p_light, p_em) < 0.15, (p_light, p_em)
