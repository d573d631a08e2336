"""The LM scaffold's layers in the port against the JAX package's, on the
CPU: the same numpy inputs (from a seeded generator) and the same weights
through both.  Float results within rtol 1e-4 / atol 1e-5 (float32 on
both sides; the two differ only in summation order), integer and layout
maps bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm

TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, params: dict):
    """Carry a JAX parameter dict (nested, numpy leaves) into a module."""
    flat = {}

    def walk(path, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(path + (k,), v)
        else:
            flat[".".join(path)] = _t(tree)

    walk((), jax.tree.map(np.asarray, params))
    module.load_state_dict(flat, strict=True)
    return module


def _perturb(params: dict, seed: int):
    """Give every constant leaf (norm scales, gates, mixes, biases) random
    values, so that its path is exercised."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(f, params)


def _cfg(name, **over):
    return (dataclasses.replace(jreg.smoke_variant(name), **over),
            dataclasses.replace(treg.smoke_variant(name), **over))


# -- norms, RoPE, MLP ----------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tlayers.rms_norm(_t(x), _t(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 33, 4, 32)).astype(np.float32)
    pos = np.arange(33, dtype=np.int32) + 100
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp_matches_jax(act):
    p = jlayers.init_mlp(jax.random.PRNGKey(2), 48, 96, jnp.float32)
    mlp = _load(tlayers.MLP(48, 96, torch.float32, "cpu"), p)
    x = np.random.default_rng(2).standard_normal((5, 48)).astype(np.float32)
    want = jlayers.apply_mlp(p, jnp.asarray(x), act)
    got = tlayers.apply_mlp(mlp, _t(x), act)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form, torch's gelu to the exact
    one; musicgen (act="gelu") needs the former."""
    h = np.linspace(-4, 4, 801, dtype=np.float32)
    want = _np(jax.nn.gelu(jnp.asarray(h)))
    got = tlayers.activation(_t(h), "gelu").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    exact = torch.nn.functional.gelu(_t(h)).numpy()
    assert np.abs(exact - want).max() > 1e-4     # the default would differ


def test_embedding_scale_rounds_the_constant_to_bf16():
    """sqrt(2560) = 50.596 is 50.5 in bf16, as jnp.asarray(.., bf16)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 2560)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = _np((jx * jnp.asarray(2560 ** 0.5, jx.dtype)).astype(jnp.float32))
    tx = _t(x).to(torch.bfloat16)
    got = ttfm.scale_embeddings(tx, 2560).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert float(torch.tensor(2560 ** 0.5, dtype=torch.bfloat16)) == 50.5
    unrounded = (tx * 2560 ** 0.5).float().numpy()  # torch's scalar product
    assert not np.array_equal(unrounded, want)
    # float32 keeps the constant
    np.testing.assert_array_equal(
        ttfm.scale_embeddings(_t(x), 2560).numpy(),
        _np(jnp.asarray(x) * jnp.asarray(2560 ** 0.5, jnp.float32)))


# -- the cyclic vocabulary ------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 3, 4])
@pytest.mark.parametrize("vocab", [512, 50, 262_144])
def test_vocab_layout_bitwise(vocab, shards):
    jl = jlayers.VocabLayout(vocab, shards, "cyclic")
    tl = tlayers.VocabLayout(vocab, shards, "cyclic")
    assert tl.pad_rows == jl.pad_rows
    tok = np.random.default_rng(vocab).integers(0, vocab, 1000)
    np.testing.assert_array_equal(
        tl.to_physical(torch.from_numpy(tok)).numpy(),
        _np(jl.to_physical(jnp.asarray(tok, jnp.int32))))
    valid = tl.valid_columns()
    want = _np(jl.cyclic.to_logical(jnp.arange(jl.pad_rows))) < vocab
    if valid is None:
        assert want.all()
    else:
        np.testing.assert_array_equal(valid.numpy(), want)


@pytest.mark.parametrize("vocab,shards", [(50, 4), (64, 1), (61, 3)])
def test_softmax_xent_physical_matches_jax(vocab, shards):
    jl = jlayers.VocabLayout(vocab, shards, "cyclic")
    tl = tlayers.VocabLayout(vocab, shards, "cyclic")
    rng = np.random.default_rng(vocab)
    logits = rng.standard_normal((3, 5, jl.pad_rows)).astype(np.float32) * 4
    labels = rng.integers(0, vocab, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.8).astype(np.float32)
    want = jlayers.softmax_xent_physical(jnp.asarray(logits),
                                         jnp.asarray(labels), jl,
                                         jnp.asarray(mask))
    got = tlayers.softmax_xent_physical(_t(logits), _t(labels), tl, _t(mask))
    np.testing.assert_allclose(float(got), float(want), **TOL)


# -- attention cores ------------------------------------------------------------

def _qkv(seed, b, tq, tk, nkv, g, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, nkv, g, hd)).astype(np.float32)
    k = rng.standard_normal((b, tk, nkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, tk, nkv, hd)).astype(np.float32)
    return q, k, v


# (causal, window, tq, tk, q_chunk, kv_chunk): chunks smaller than the
# sequence, so tiles are skipped; 80 / 8 = 10 q chunks takes the grouped
# triangle skip; 45 pads both sides; cross-attention is non-causal
ATTEND_CASES = [
    (True, 0, 48, 48, 16, 16),
    (True, 0, 80, 80, 8, 16),
    (True, 0, 45, 45, 16, 8),
    (True, 8, 64, 64, 16, 8),
    (True, 12, 45, 45, 8, 8),
    (True, 24, 40, 40, 32, 16),
    (False, 0, 20, 13, 8, 4),
]


@pytest.mark.parametrize("causal,window,tq,tk,qc,kc", ATTEND_CASES)
def test_attend_chunked_matches_jax(causal, window, tq, tk, qc, kc):
    q, k, v = _qkv(tq * 7 + window, 2, tq, tk, 2, 3, 16)
    qp = np.arange(tq, dtype=np.int32)
    kp = np.arange(tk, dtype=np.int32)
    want = jattn._attend_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        jnp.asarray(kp), causal=causal, window=window, q_chunk=qc,
        kv_chunk=kc)
    got = tattn._attend_chunked(_t(q), _t(k), _t(v), _t(qp).long(),
                                _t(kp).long(), causal=causal, window=window,
                                q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_kv_chunk_ranges_skip_masked_tiles():
    """A window layer visits a band of (qc + window - 2) // kc + 2 chunks
    (the q chunk's rows reach back ``window`` slots); a long global causal
    layer skips most of the upper triangle."""
    band = tattn.kv_chunk_ranges(16, 16, 128, 128, causal=True, window=256)
    assert all(len(r) == 4 for r in band)
    assert band[0] == range(0, 4) and band[-1] == range(12, 16)
    assert band[5] == range(3, 7)       # rows 640..767 see keys from 385 on
    tri = tattn.kv_chunk_ranges(16, 16, 128, 128, causal=True, window=0)
    assert sum(map(len, tri)) < 16 * 16 * 0.7
    assert all(max(r) >= qi for qi, r in enumerate(tri))   # never too few
    full = tattn.kv_chunk_ranges(4, 4, 128, 128, causal=True, window=0)
    assert all(r == range(4) for r in full)


@pytest.mark.parametrize("window,pos", [(0, 20), (0, 31), (5, 20), (40, 9)])
def test_attend_decode_matches_jax(window, pos):
    """Slots past ``pos`` are empty (zeros), slots before the window
    masked in the reference; the port attends over the live range alone,
    and its statistics are the softmax's."""
    q, k, v = _qkv(pos + window, 2, 1, 32, 2, 3, 16)
    k[:, pos + 1:] = 0
    v[:, pos + 1:] = 0
    kp = np.arange(32, dtype=np.int32)
    want = jattn._attend_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(kp),
                                jnp.int32(pos), window)
    lo, hi = tattn.live_range(pos, window)          # the port's decode slice
    m, l, out = tattn._attend_decode(_t(q), _t(k)[:, lo:hi], _t(v)[:, lo:hi])
    np.testing.assert_allclose(out.view(q.shape).numpy(), _np(want), **TOL)
    s = np.einsum("bqhgd,bkhd->bhgk", q, k[:, lo:hi]) * q.shape[-1] ** -0.5
    np.testing.assert_allclose(m.numpy(), s.max(-1), **TOL)
    np.testing.assert_allclose(l.numpy(), np.exp(
        s - s.max(-1, keepdims=True)).sum(-1), **TOL)


# -- attention modules ----------------------------------------------------------

def _x(seed, b, t, d):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["gemma3-4b", "yi-6b"])
def test_self_attention_prefill_and_decode_match_jax(name):
    jcfg, tcfg = _cfg(name, use_qk_norm=True)
    p = _perturb(jattn.init_attn(jax.random.PRNGKey(4), jcfg), 4)
    mod = _load(tattn.Attention(tcfg, device="cpu"), p)
    x = _x(5, 2, 20, jcfg.d_model)
    pos = np.arange(20, dtype=np.int32)
    for window in (0, 8):
        want, (wk, wv) = jattn.self_attention(
            p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
            window=window, theta=1e4)
        with torch.no_grad():
            got, (gk, gv) = mod(_t(x), positions=_t(pos).long(),
                                window=window, theta=1e4)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        np.testing.assert_allclose(gk.numpy(), _np(wk), **TOL)
        np.testing.assert_allclose(gv.numpy(), _np(wv), **TOL)
        # one decode step at position 20 against a 24-slot cache
        ck = np.zeros((2, 24) + wk.shape[2:], np.float32)
        cv = np.zeros_like(ck)
        ck[:, :20], cv[:, :20] = _np(wk), _np(wv)
        x1 = _x(6, 2, 1, jcfg.d_model)
        want, nk, nv = jattn.self_attention_decode(
            p, jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
            jnp.int32(20), jcfg, window=window, theta=1e4)
        tk_, tv_ = _t(ck), _t(cv)
        with torch.no_grad():
            got = mod.decode(_t(x1), tk_, tv_, 20, window=window, theta=1e4)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        np.testing.assert_allclose(tk_.numpy(), _np(nk), **TOL)
        np.testing.assert_allclose(tv_.numpy(), _np(nv), **TOL)


def test_mla_prefill_and_decode_match_jax():
    jcfg, tcfg = _cfg("deepseek-v2-lite-16b")
    p = _perturb(jattn.init_mla(jax.random.PRNGKey(7), jcfg), 7)
    mod = _load(tattn.MLA(tcfg, device="cpu"), p)
    x = _x(8, 2, 18, jcfg.d_model)
    pos = np.arange(18, dtype=np.int32)
    want, (wc, wr) = jattn.mla_attention(p, jnp.asarray(x), jcfg,
                                         positions=jnp.asarray(pos))
    with torch.no_grad():
        got, (gc, gr) = mod(_t(x), positions=_t(pos).long())
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gc.numpy(), _np(wc), **TOL)
    np.testing.assert_allclose(gr.numpy(), _np(wr), **TOL)
    cc = np.zeros((2, 21, wc.shape[-1]), np.float32)
    cr = np.zeros((2, 21, wr.shape[-1]), np.float32)
    cc[:, :18], cr[:, :18] = _np(wc), _np(wr)
    x1 = _x(9, 2, 1, jcfg.d_model)
    want, nc, nr = jattn.mla_attention_decode(
        p, jnp.asarray(x1), jnp.asarray(cc), jnp.asarray(cr), jnp.int32(18),
        jcfg)
    tc, tr = _t(cc), _t(cr)
    with torch.no_grad():
        got = mod.decode(_t(x1), tc, tr, 18)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(tc.numpy(), _np(nc), **TOL)
    np.testing.assert_allclose(tr.numpy(), _np(nr), **TOL)


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_cross_attention_matches_jax(name):
    jcfg, tcfg = _cfg(name)
    p = _perturb(jattn.init_cross_attn(jax.random.PRNGKey(10), jcfg), 10)
    assert float(p["gate"]) != 0.0               # tanh(gate) passes the path
    mod = _load(tattn.CrossAttention(tcfg, device="cpu"), p)
    x = _x(11, 2, 13, jcfg.d_model)
    cond = _x(12, 2, jcfg.cond_len, jcfg.cond_dim_)
    want = jattn.cross_attention(p, jnp.asarray(x), jnp.asarray(cond), jcfg)
    with torch.no_grad():
        got = mod(_t(x), _t(cond))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# -- MoE and the SSD --------------------------------------------------------------

@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e"])
def test_moe_dense_block_matches_jax(name):
    jcfg, tcfg = _cfg(name)
    p = jmoe.init_moe(jax.random.PRNGKey(13), jcfg)
    mod = _load(tmoe.MoE(tcfg, device="cpu"), p)
    x = _x(14, 2, 11, jcfg.d_model)
    want, waux = jmoe.moe_block(p, jnp.asarray(x), jcfg, None)
    with torch.no_grad():
        got, gaux = mod(_t(x))
        gates, ids, _ = tmoe._route(mod, _t(x).reshape(22, -1), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)
    wg, wi, _ = jmoe._route(p, jnp.asarray(x).reshape(22, -1), jcfg)
    np.testing.assert_array_equal(ids.numpy(), _np(wi))
    np.testing.assert_allclose(gates.numpy(), _np(wg), **TOL)


def _ssd_inputs(seed, b=2, t=45, h=3, p=8, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("chunk", [8, 16, 45, 64])
def test_ssd_chunked_matches_jax(chunk):
    args = _ssd_inputs(15)
    state0 = np.random.default_rng(16).standard_normal((2, 3, 8, 6)).astype(
        np.float32)
    wy, ws = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                              init_state=jnp.asarray(state0))
    gy, gs = tssm.ssd_chunked(*map(_t, args), chunk, init_state=_t(state0))
    np.testing.assert_allclose(gy.numpy(), _np(wy), **TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **TOL)


def test_ssd_chunked_is_chunk_invariant():
    args = list(map(_t, _ssd_inputs(17, t=64)))
    y0, s0 = tssm.ssd_chunked(*args, 64)
    for chunk in (4, 8, 16, 32):
        y, s = tssm.ssd_chunked(*args, chunk)
        np.testing.assert_allclose(y.numpy(), y0.numpy(), **TOL)
        np.testing.assert_allclose(s.numpy(), s0.numpy(), **TOL)


def test_ssm_block_prefill_and_decode_match_jax():
    jcfg, tcfg = _cfg("mamba2-370m")
    p = _perturb(jssm.init_ssm(jax.random.PRNGKey(18), jcfg), 18)
    mod = _load(tssm.SSM(tcfg, device="cpu"), p)
    x = _x(19, 2, 21, jcfg.d_model)
    want, (ws, wt) = jssm.ssm_block(p, jnp.asarray(x), jcfg,
                                    return_state=True)
    with torch.no_grad():
        got, (gs, gt) = mod(_t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **TOL)
    np.testing.assert_allclose(gt.numpy(), _np(wt), **TOL)
    x1 = _x(20, 2, 1, jcfg.d_model)
    want, ns, nt = jssm.ssm_block_decode(p, jnp.asarray(x1), ws, wt, jcfg)
    state, tail = gs.clone(), gt.clone()
    with torch.no_grad():
        got = mod.decode(_t(x1), state, tail)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(state.numpy(), _np(ns), **TOL)
    np.testing.assert_allclose(tail.numpy(), _np(nt), **TOL)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(21)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for prev in (None, tail):
        want, wt = jssm._causal_conv(
            jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias),
            None if prev is None else jnp.asarray(prev))
        got, gt = tssm._causal_conv(_t(xbc), _t(w), _t(bias),
                                    None if prev is None else _t(prev))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        np.testing.assert_array_equal(gt.numpy(), _np(wt))
