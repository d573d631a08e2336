"""The published DeepSeek-V2-Lite in the port (``configs.deepseek_v2_lite_16b.
published``: raw top-6 gates, YaRN, unscaled embeddings, the balance loss
per sequence, an expert-parallel rank's share of the experts) against the
plain reference (``repro_torch/reference/deepseek_v2.py``) at a small size
on the CPU in float32, with seeded random weights; the share against the
uncut layer; the held-experts path against the dense one; the step's
device spans and counters.  No JAX: the registry twin is held to the JAX
package by ``test_torch_lm_*.py``."""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import deepseek_v2_lite_16b as ds
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers, moe as moe_mod
from repro_torch.models import transformer as tfm
from repro_torch.obs import ObsConfig, ObsSession
from repro_torch.reference import deepseek_v2 as ref
from repro_torch.train import loop

ROOT = Path(__file__).resolve().parents[1]
E = 16
# the published keys at small widths (the YaRN settings, the router's
# softmax top-6, the shared experts and the dense first layer as published)
KEYS = dict(ds.PUBLISHED, hidden_size=64, num_attention_heads=4,
            kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
            v_head_dim=32, intermediate_size=128, moe_intermediate_size=32,
            n_routed_experts=E, num_hidden_layers=3, vocab_size=256)
B, S = 3, 48
# float32 on both sides: the port's chunked online softmax and its
# products add in another order than the reference's whole-matrix ones,
# a few float32 ulps of the largest value per layer
LOGIT_ATOL = 2e-5           # times the largest |logit|
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5    # atol: times the leaf's largest |g|


def _cfg(held=E, rank=0):
    cfg = ds.published(KEYS, experts_held=held, expert_rank=rank,
                       dtype="float32")
    # small tiles, so that the chunked core visits several of them
    return dataclasses.replace(cfg, attn_chunk_q=16, attn_chunk_kv=32)


def _ref_cfg(held=E, rank=0):
    return ref.config_of(dict(KEYS, n_routed_experts=held),
                         {"n_routed_experts": E}, ds.AUX_ALPHA, rank)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, KEYS["vocab_size"], (B, S), generator=g)
    tgt = torch.randint(0, KEYS["vocab_size"], (B, S), generator=g)
    return tok, tgt, torch.ones(B, S)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _close(got, want, rtol, atol_rel, what):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol_rel * scale,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("held,rank", [(E, 0), (4, 1), (4, 3)])
def test_published_model_matches_the_reference(held, rank):
    """Logits of every sequence, the loss and every gradient of the port's
    published model (all experts: the dense path; a share: the held-experts
    path) against the reference's, from the same weights."""
    cfg = _cfg(held, rank)
    model = tfm.init_params(3, cfg, device="cpu")
    tok, tgt, mask = _batch()
    p = _params(model)
    rcfg = _ref_cfg(held, rank)
    with torch.no_grad():
        logits, _ = model(tok, remat=False)
        for i in range(B):
            want, _ = ref.forward(p, tok[i], rcfg)
            _close(logits[i], want, 0.0, LOGIT_ATOL, f"logits of {i}")
    loss, _ = tfm.loss_fn(model, tok, tgt, mask)
    loss.backward()
    r_loss, r_grads = ref.loss_and_grads(p, tok, tgt, rcfg)
    torch.testing.assert_close(loss.detach(), r_loss, rtol=LOSS_RTOL,
                               atol=0.0)
    for n, q in model.named_parameters():
        _close(q.grad, r_grads[n], GRAD_RTOL, GRAD_ATOL, n)


def test_a_step_matches_the_references_adamw():
    """A step after a first one (moments not zero): the port's new
    parameters against the reference's step from the same state."""
    cfg = _cfg(4, 2)
    tc = TrainConfig()
    state = loop.init_state(5, cfg, device="cpu")
    step = loop.make_train_step(cfg, tc)
    tok, tgt, mask = _batch(1)
    state, _ = step(state, tok, tgt, mask)
    before = _params(state.model)
    m = {n: t.clone() for n, t in state.opt.m.items()}
    v = {n: t.clone() for n, t in state.opt.v.items()}
    count = int(state.opt.step)
    state, met = step(state, *_batch(2))
    opt = {"lr": tc.learning_rate, "weight_decay": tc.weight_decay,
           "beta1": tc.beta1, "beta2": tc.beta2, "eps": tc.eps,
           "warmup": tc.warmup_steps, "total": tc.total_steps,
           "clip": tc.grad_clip}
    loss, _, new = ref.train_step(before, m, v, count, *_batch(2)[:2],
                                  _ref_cfg(4, 2), opt)
    torch.testing.assert_close(met["loss"], loss, rtol=LOSS_RTOL, atol=0.0)
    for n, q in state.model.named_parameters():
        # the change, lr times an Adam direction of order 1, to within the
        # float32 rounding of p - lr * delta: an ulp of p where the two
        # round apart
        ulp = torch.finfo(torch.float32).eps * before[n].abs().max()
        torch.testing.assert_close(q.detach() - before[n],
                                   new[n] - before[n], rtol=1e-3,
                                   atol=float(2 * ulp), msg=n)


def _moe_inputs(cfg, seed=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=g)


def test_the_shares_add_up_to_the_uncut_layer():
    """The ranks' held-expert parts (here 4 ranks of 4 experts), with the
    shared experts (which every rank computes alike) counted once, are the
    uncut reference layer's output; each rank's balance loss is the uncut
    one's (the router is whole on every rank)."""
    held = 4
    full = tfm.init_params(6, _cfg(), device="cpu").blocks[0].moe
    x = _moe_inputs(_cfg())
    routed, auxes = 0.0, []
    for r in range(E // held):
        part = moe_mod.MoE(_cfg(held, r), device="cpu")
        with torch.no_grad():
            for name, t in part.named_parameters():
                src = dict(full.named_parameters())[name]
                t.copy_(src[r::E // held] if ".experts." in f".{name}"
                        else src)
            _, aux = part(x)
        routed = routed + part.last_routed.reshape(x.shape)
        auxes.append(aux)
    with torch.no_grad():
        shared = full.shared(x.reshape(-1, x.shape[-1]), "silu")
        got = routed + shared.reshape(x.shape)
        p = {f"moe.{n}": t for n, t in full.named_parameters()}
        for i in range(B):
            want, aux = ref.experts(p, "moe.", x[i], _ref_cfg(),
                                    ref._Plain(None))
            _close(got[i], want, 1e-5, 1e-6, f"sequence {i}")
    want_aux = sum(ref.experts(p, "moe.", x[i], _ref_cfg(),
                               ref._Plain(None))[1] for i in range(B)) / B
    for aux in auxes:
        torch.testing.assert_close(aux, want_aux, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("norm", [False, True])
def test_the_held_path_with_every_expert_is_the_dense_path(norm):
    cfg = dataclasses.replace(_cfg(), norm_topk_prob=norm)
    layer = tfm.init_params(7, cfg, device="cpu").blocks[0].moe
    x = _moe_inputs(cfg, 8).reshape(B * S, -1)
    with torch.no_grad():
        y_held, aux_held = moe_mod.moe_block_held(layer, x, cfg, B)
        y_dense, aux_dense = moe_mod.moe_block_dense(layer, x, cfg, B)
    torch.testing.assert_close(y_held, y_dense, rtol=1e-5, atol=1e-6)
    assert torch.equal(aux_held, aux_dense)


def test_held_pairs_are_the_ranks_experts_grouped():
    cfg = _cfg(4, 1)
    ids = torch.tensor([[1, 5, 0, 2, 9, 13], [4, 13, 3, 6, 12, 8]])
    pairs, counts = moe_mod.held_pairs(ids, cfg)
    # rank 1 of 4 holds experts 1, 5, 9, 13 at local 0..3
    assert counts == [1, 1, 1, 2]
    assert ids.reshape(-1)[pairs].tolist() == [1, 5, 9, 13, 13]
    assert (pairs // cfg.top_k).tolist() == [0, 0, 0, 0, 1]


def test_a_share_that_does_not_split_the_experts_is_refused():
    with pytest.raises(ValueError):
        ds.published(KEYS, experts_held=5)
    with pytest.raises(ValueError):
        ds.published(KEYS, experts_held=4, expert_rank=4)


def test_yarn_frequencies_and_softmax_scale():
    """The port's YaRN (``layers.rope_for``) against the reference's, and
    by hand at the published settings: the correction dimensions of 32
    and 1 rotations over 4,096 positions at 64 dimensions are 10 and 23,
    so the first 10 frequencies are the original ones and those from 23
    on are divided by 40; the softmax scale gains (1 + 0.1 * 0.707 *
    ln 40) ** 2 and cos and sin are not scaled."""
    cfg = ds.published()
    rope = layers.rope_for(cfg, 64, cfg.rope_theta)
    inv, cs, mult = ref.yarn(ref.config_of(ds.PUBLISHED, {}, 0.001))
    torch.testing.assert_close(rope.inv_freq, inv, rtol=1e-6, atol=0.0)
    assert rope.cos_sin == pytest.approx(cs) == 1.0
    assert rope.softmax == pytest.approx(mult)
    assert mult == pytest.approx((1 + 0.1 * 0.707 * math.log(40)) ** 2)
    assert mult == pytest.approx(1.5896, abs=1e-4)
    plain = layers.rope_freqs(64, 10000.0)
    torch.testing.assert_close(rope.inv_freq[:11], plain[:11])
    torch.testing.assert_close(rope.inv_freq[23:], plain[23:] / 40)
    mid = rope.inv_freq[11:23]
    assert bool(((mid < plain[11:23]) & (mid > plain[11:23] / 40)).all())
    # the registry twin keeps plain RoPE
    twin = layers.rope_for(ds.CONFIG, 64, 10000.0)
    assert torch.equal(twin.inv_freq, plain)
    assert (twin.cos_sin, twin.softmax) == (1.0, 1.0)


def test_raw_gates_and_the_sequence_balance_loss():
    cfg = _cfg()
    layer = tfm.init_params(9, cfg, device="cpu").blocks[0].moe
    x = _moe_inputs(cfg, 10).reshape(B * S, -1)
    with torch.no_grad():
        gates, ids, probs = moe_mod._route(layer, x, cfg)
        top, top_ids = torch.topk(probs, cfg.top_k, -1)
        assert torch.equal(ids, top_ids)
        torch.testing.assert_close(gates, top)           # not renormalised
        assert float(gates.sum(-1).max()) < 1.0
        g_norm, _, _ = moe_mod._route(
            layer, x, dataclasses.replace(cfg, norm_topk_prob=True))
        torch.testing.assert_close(g_norm.sum(-1), torch.ones(B * S))
        # the published gate's seq_aux loss, written as its code does
        k = cfg.top_k
        ce = torch.zeros(B, E).scatter_add_(
            1, ids.reshape(B, -1), torch.ones(B, S * k)).div_(S * k / E)
        want = (ce * probs.view(B, S, E).mean(1)).sum(1).mean()
        torch.testing.assert_close(moe_mod.balance_loss(ids, probs, cfg, B),
                                   want)
        # without seq_aux: the whole batch's, the registry twin's
        flat = dataclasses.replace(cfg, seq_aux=False)
        assert torch.equal(
            moe_mod.balance_loss(ids, probs, flat, B),
            moe_mod.aux_from_stats(moe_mod.aux_stats(ids, probs, flat,
                                                     B * S), flat))


def test_embeddings_unscaled_and_the_twin_departures():
    cfg = _cfg()
    model = tfm.init_params(11, cfg, device="cpu")
    tok = _batch()[0]
    with torch.no_grad():
        assert torch.equal(model._embed(tok), model.embed.table[tok])
    twin = ds.CONFIG
    assert (twin.norm_topk_prob, twin.yarn_factor, twin.seq_aux,
            twin.scale_embed, twin.held_experts_) == (True, 0.0, False,
                                                      True, 64)
    pub = ds.published(num_layers=9, experts_held=8, vocab_size=12800)
    assert (pub.norm_topk_prob, pub.yarn_factor, pub.seq_aux,
            pub.scale_embed, pub.held_experts_, pub.num_experts,
            pub.router_aux_weight) == (False, 40.0, True, False, 8, 64,
                                       0.001)


def test_an_embedding_gradient_adds_its_repeats_in_float32():
    """A bf16 table's rows of an id repeated thousands of times: their
    gradient is the float32 sum rounded once (to within bf16's rounding,
    where adding in bf16 loses several per cent)."""
    table = torch.randn(50, 32).bfloat16().requires_grad_()
    idx = torch.zeros(6000, dtype=torch.long)
    idx[::3] = 7
    g = torch.randn(6000, 32).bfloat16()
    layers.rows_of(table, idx).backward(g)
    want = torch.zeros(50, 32, dtype=torch.float64).index_add_(
        0, idx, g.double())
    err = (table.grad.double() - want).norm() / want.norm()
    assert float(err) < 2 ** -8


def test_the_step_marks_its_spans_and_counters():
    """With an obs session, a step's spans on the device lane: the whole
    step, attention and the MoE layers forward and backward, the dense
    FFN, the head and the optimizer inside it; the held pairs and the
    experts' tokens as counters.  Without one, none."""
    cfg = _cfg(4, 0)
    tc = TrainConfig(microbatch=1)
    state = loop.init_state(12, cfg, device="cpu")
    step = loop.make_train_step(cfg, tc)
    batch = _batch(3)
    pairs = []
    real = moe_mod.held_pairs

    def spy(ids, c):
        out = real(ids, c)
        pairs.append(sum(out[1]))
        return out

    obs = ObsSession(ObsConfig(enabled=True, metrics=False)).install()
    moe_mod.held_pairs = spy
    try:
        step(state, *batch)
    finally:
        moe_mod.held_pairs = real
        obs.close(save=False)
    ev = obs.tracer.events()
    lane = [e for e in ev if e.get("cat") == "cpu" and e.get("ph") == "X"]
    names = [e["name"] for e in lane]
    whole = [e for e in lane if e["name"] == "lm.step.device"]
    assert len(whole) == 1
    t0, t1 = whole[0]["ts"], whole[0]["ts"] + whole[0]["dur"]
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1e-3
               for e in lane)
    layers_n = cfg.num_layers
    assert names.count("lm.attn") == names.count("lm.attn.bwd") == layers_n
    for part in ("lm.moe.route", "lm.moe.experts", "lm.moe.combine",
                 "lm.moe.bwd"):
        assert names.count(part) == layers_n - 1, part
    assert names.count("lm.ffn.dense") == 1
    assert names.count("lm.head") == 2 and names.count("lm.optimizer") == 1
    # the forward's pairs alone, not the recompute's
    counters = {e["name"]: e["args"] for e in ev if e.get("ph") == "C"}
    assert counters["lm.moe.held_pairs"]["pairs"] == sum(
        pairs[:layers_n - 1])
    assert counters["lm.moe.expert_tokens"]["max"] >= \
        counters["lm.moe.expert_tokens"]["mean"] > 0
    obs2 = ObsSession(ObsConfig(enabled=True, metrics=False))
    step(state, *batch)
    assert obs2.tracer.events() == []


def test_the_benchs_reference_is_the_same_file():
    assert (ROOT / "bench" / "reference" / "deepseek_v2.py").read_bytes() \
        == (ROOT / "src" / "repro_torch" / "reference"
            / "deepseek_v2.py").read_bytes()


def test_the_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse((ROOT / "src" / "repro_torch" / "reference"
                      / "deepseek_v2.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "torch"}
