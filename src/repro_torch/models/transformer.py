"""Model assembly: every architecture of the registry through one code path.

The twin of the JAX package's ``models/transformer.py``.  The JAX package
scans stacked [L, ...] parameters, one scan per run of same-window layers;
here the layers are an ``nn.ModuleList`` and a plain loop runs them, each
with its own window and RoPE base.  Structurally different layers
(llama-vision's gated cross-attention, deepseek's leading dense-FFN layers)
live in their own lists, interleaved by the same loop.

Caches are dicts of [L, B, ...] tensors allocated once
(``allocate_cache``, from ``registry.cache_shapes``); prefill writes each
layer's K/V into the first S_prompt slots and decode writes one slot a
step, in place.

Training rematerialises each layer (``cfg.remat``): the layer's forward
runs under ``torch.utils.checkpoint``, which keeps its input alone and runs
it again in the backward, as the reference's ``jax.checkpoint`` around each
scanned layer and each cross-attention layer does.

Entry points:
  forward(...)       logits over full sequences (optionally filling a cache)
  loss_fn(...)       the training loss (cross-entropy + router aux)
  prefill(...)       last-position logits + a populated cache
  decode_step(...)   one token with the cache (the serve path)
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.models.attention import MLA, Attention, CrossAttention
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, VocabLayout,
                                       dtype_of, lm_head_logits, param,
                                       softmax_xent_physical)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM
from repro_torch.sharding.specs import SINGLE, MeshCtx

SEQ_LEAVES = ("k", "v", "ckv", "krope")     # cache leaves with a seq axis


def layer_plan(cfg: ModelConfig) -> dict:
    """How the depth dimension is organised (also used by cache builders).

    Returns {"dense": nd, "main": nm, "cross": nc, "group": g} where the
    runtime order is: dense layers, then (for vlm) nc groups of [1 cross +
    g main], else nm main layers.
    """
    if cfg.cross_attn_mode == "interleaved":
        g = cfg.cross_attn_group
        nc = cfg.num_layers // (g + 1)
        nm = nc * g
        assert nc * (g + 1) == cfg.num_layers, (cfg.num_layers, g)
        return {"dense": 0, "main": nm, "cross": nc, "group": g}
    nd = cfg.first_dense_layers
    return {"dense": nd, "main": cfg.num_layers - nd, "cross": 0, "group": 0}


def vocab_layout(cfg: ModelConfig, ctx: MeshCtx = SINGLE) -> VocabLayout:
    return VocabLayout(cfg.vocab_size, ctx.model_size, cfg.vocab_layout)


def layer_meta(cfg: ModelConfig, n: int, skip: int
               ) -> Tuple[List[int], List[float]]:
    """Per-layer (window, rope-theta) of ``n`` layers after ``skip``: global
    layers (window 0) take ``rope_theta_global`` where it is set."""
    wins = list(cfg.windows())[skip:skip + n]
    thetas = [cfg.rope_theta_global if (w == 0 and cfg.rope_theta_global)
              else cfg.rope_theta for w in wins]
    return wins, thetas


def scale_embeddings(x: torch.Tensor, d_model: int) -> torch.Tensor:
    """``x * sqrt(d_model)`` with the constant rounded to x's dtype first,
    as the reference's ``jnp.asarray(d_model ** 0.5, x.dtype)`` does (in
    bf16 sqrt(2560) = 50.596 becomes 50.5)."""
    return x * torch.tensor(d_model ** 0.5, dtype=x.dtype)


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer.  kind: "main" (the uniform stack), "dense_ffn" (deepseek
    leading layers), "cross" (vlm gated cross-attention)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        d, eps, dt = cfg.d_model, cfg.norm_eps, dtype_of(cfg)
        self.cfg, self.kind = cfg, kind
        self.ln1 = RMSNorm(d, eps, device)
        if kind == "cross":
            self.attn_x = CrossAttention(cfg, device)
            self.ln2 = RMSNorm(d, eps, device)
            self.mlp = MLP(d, cfg.d_ff, dt, device)
            self.mlp_gate = param((), torch.float32, device)
            return
        self.ssm_only = cfg.ssm_state > 0 and not cfg.hybrid
        if self.ssm_only and not cfg.has_attention:
            self.ssm = SSM(cfg, device)
            return                  # mamba2 block: norm + mixer only
        if cfg.has_attention:
            self.attn = (MLA(cfg, device) if cfg.use_mla
                         else Attention(cfg, device=device))
        if cfg.hybrid:
            self.ssm = SSM(cfg, device)
            self.attn_out_norm = RMSNorm(d, eps, device)
            self.ssm_out_norm = RMSNorm(d, eps, device)
            self.mix_attn = param((), torch.float32, device)
            self.mix_ssm = param((), torch.float32, device)
        if cfg.cross_attn_mode == "every":
            self.ln_x = RMSNorm(d, eps, device)
            self.attn_x = CrossAttention(cfg, device)
        self.ln2 = RMSNorm(d, eps, device)
        if cfg.is_moe and kind != "dense_ffn":
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(d, cfg.d_ff, dt, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        for child in self.children():
            child.reset_parameters(g)
        with torch.no_grad():
            for name, value in (("mlp_gate", 0.0), ("mix_attn", 1.0),
                                ("mix_ssm", 1.0)):
                if hasattr(self, name):
                    getattr(self, name).fill_(value)

    # -- shared tails ------------------------------------------------------

    def _cross_layer(self, x, cond):
        x = x + self.attn_x(self.ln1(x), cond)
        h = self.ln2(x)
        return x + torch.tanh(self.mlp_gate).to(x.dtype) * self.mlp(
            h, self.cfg.act)

    def _mix(self, x, a_out, s_out):
        dt = x.dtype
        return x + 0.5 * (self.mix_attn.to(dt) * self.attn_out_norm(a_out)
                          + self.mix_ssm.to(dt) * self.ssm_out_norm(s_out))

    def _ffn(self, x, cond):
        """Cross-attention ("every" mode), then the MLP or MoE residual."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.cross_attn_mode == "every":
            x = x + self.attn_x(self.ln_x(x), cond)
        h = self.ln2(x)
        if hasattr(self, "moe"):
            y, aux = self.moe(h)
            return x + y, aux
        return x + self.mlp(h, self.cfg.act), aux

    # -- full sequence -----------------------------------------------------

    def full(self, x, *, positions, window: int, theta: float, cond):
        """Full-sequence block.  Returns (x, cache entry, aux)."""
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind == "cross":
            return self._cross_layer(x, cond), {}, zero
        h = self.ln1(x)
        if self.ssm_only:
            out, (state, tail) = self.ssm(h)
            return x + out, {"ssm": state, "conv": tail}, zero
        if self.cfg.use_mla:
            a_out, (c0, c1) = self.attn(h, positions=positions)
            entry = {"ckv": c0, "krope": c1}
        else:
            a_out, (c0, c1) = self.attn(h, positions=positions, window=window,
                                        theta=theta)
            entry = {"k": c0, "v": c1}
        if self.cfg.hybrid:
            s_out, (state, tail) = self.ssm(h)
            x = self._mix(x, a_out, s_out)
            entry.update(ssm=state, conv=tail)
        else:
            x = x + a_out
        x, aux = self._ffn(x, cond)
        return x, entry, aux

    # -- one token ---------------------------------------------------------

    def decode(self, x, cache: Dict[str, torch.Tensor], pos: int, *,
               window: int, theta: float, cond):
        """One-token block; ``cache`` holds this layer's views, updated in
        place.  Returns (x, aux)."""
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind == "cross":
            return self._cross_layer(x, cond), zero
        h = self.ln1(x)
        if self.ssm_only:
            return x + self.ssm.decode(h, cache["ssm"], cache["conv"]), zero
        if self.cfg.use_mla:
            a_out = self.attn.decode(h, cache["ckv"], cache["krope"], pos)
        else:
            a_out = self.attn.decode(h, cache["k"], cache["v"], pos,
                                     window=window, theta=theta)
        if self.cfg.hybrid:
            s_out = self.ssm.decode(h, cache["ssm"], cache["conv"])
            x = self._mix(x, a_out, s_out)
        else:
            x = x + a_out
        return self._ffn(x, cond)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """Embedding (cyclic physical rows), the layer lists, final norm and
    the LM head (the embedding itself when tied).  Parameters are
    allocated uninitialised; ``init_params`` draws them, and
    ``convert.lm_params_from_arrays`` carries a JAX model's in."""

    def __init__(self, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
                 device: Device = None):
        super().__init__()
        dev = resolve_device(device)
        plan = layer_plan(cfg)
        self.cfg, self.plan = cfg, plan
        self.layout = vocab_layout(cfg, ctx)
        dt = dtype_of(cfg)
        self.embed = Embedding(self.layout, cfg.d_model, dt, dev)
        self.blocks = nn.ModuleList(Block(cfg, "main", dev)
                                    for _ in range(plan["main"]))
        if plan["dense"]:
            self.dense_blocks = nn.ModuleList(
                Block(cfg, "dense_ffn", dev) for _ in range(plan["dense"]))
        if plan["cross"]:
            self.cross_blocks = nn.ModuleList(
                Block(cfg, "cross", dev) for _ in range(plan["cross"]))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(self.layout, cfg.d_model, dt, dev)
        self._dense_meta = layer_meta(cfg, plan["dense"], 0)
        self._main_meta = layer_meta(cfg, plan["main"], plan["dense"])

    @property
    def head(self) -> Embedding:
        return self.lm_head if not self.cfg.tie_embeddings else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def reset_parameters(self, g: torch.Generator) -> None:
        for child in self.children():
            if isinstance(child, nn.ModuleList):
                for blk in child:
                    blk.reset_parameters(g)
            else:
                child.reset_parameters(g)

    def schedule(self) -> Iterator[tuple]:
        """The layers in run order: ``(cache stack or None, index in it,
        block, window, theta)``."""
        wins, thetas = self._dense_meta
        for i in range(self.plan["dense"]):
            yield "dense", i, self.dense_blocks[i], wins[i], thetas[i]
        wins, thetas = self._main_meta
        g = self.plan["group"]
        for i in range(self.plan["main"]):
            if self.plan["cross"] and i % g == 0:
                yield (None, i // g, self.cross_blocks[i // g], 0,
                       self.cfg.rope_theta)
            yield "main", i, self.blocks[i], wins[i], thetas[i]

    def _embed(self, tokens):
        return scale_embeddings(self.embed(tokens), self.cfg.d_model)

    def forward(self, tokens: torch.Tensor, cond: Optional[torch.Tensor] = None,
                *, caches: Optional[dict] = None, head_at=None,
                remat: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  tokens: [B, S].  Returns
        ``(logits_physical [B, S', Vpad], aux)``, S' the positions
        ``head_at`` selects (all by default).  With ``caches`` (an
        ``allocate_cache`` dict with at least S slots) each layer's K/V and
        SSM state are written into it.  ``remat`` (default ``cfg.remat``)
        checkpoints each layer while gradients are recorded; no cache is
        written then."""
        b, s = tokens.shape
        remat = self.cfg.remat if remat is None else remat
        remat = remat and torch.is_grad_enabled()
        if remat and caches is not None:
            raise ValueError("no cache is written under remat: pass "
                             "remat=False")
        if cond is not None:
            # the modality frontend is a stub: no gradient flows to it
            # (the reference's stop_gradient)
            cond = cond.detach()
        positions = torch.arange(s, dtype=torch.int64, device=tokens.device)
        x = self._embed(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for stack, i, blk, win, th in self.schedule():
            if remat:
                x, a = checkpoint(_layer_out, blk, x, positions, win, th,
                                  cond, use_reentrant=False,
                                  preserve_rng_state=False)
                aux = aux + a
                continue
            x, entry, a = blk.full(x, positions=positions, window=win,
                                   theta=th, cond=cond)
            aux = aux + a
            if caches is not None and stack is not None:
                for name, val in entry.items():
                    dst = caches[stack][name][i]
                    (dst[:, :s] if name in SEQ_LEAVES else dst).copy_(val)
        x = self.final_norm(x if head_at is None else x[:, head_at])
        return lm_head_logits(self.head, x), aux

    def decode_step(self, token: torch.Tensor, caches: dict, pos: int,
                    cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step.  token: [B] int; ``pos`` (a Python int) is the
        position being written.  Returns logits [B, Vpad]; the caches are
        updated in place."""
        x = self._embed(token[:, None])
        for stack, i, blk, win, th in self.schedule():
            view = ({} if stack is None else
                    {name: t[i] for name, t in caches[stack].items()})
            x, _ = blk.decode(x, view, pos, window=win, theta=th, cond=cond)
        return lm_head_logits(self.head, self.final_norm(x))[:, 0]


def _layer_out(blk: Block, x, positions, window: int, theta: float, cond):
    """One layer's output and aux loss (what a rematerialised layer keeps)."""
    x, _, aux = blk.full(x, positions=positions, window=window, theta=theta,
                         cond=cond)
    return x, aux


# ---------------------------------------------------------------------------
# Public entry points (the twins' names)
# ---------------------------------------------------------------------------

def init_params(seed, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
                device: Device = None) -> Transformer:
    """A model with random weights drawn from ``seed`` (an int or a
    ``torch.Generator`` on the model's device), on the card unless
    ``device`` says otherwise.  The draws follow the JAX package's
    distributions, not its bits: parity starts from carried weights."""
    model = Transformer(cfg, ctx, device)
    g = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=model.device).manual_seed(int(seed))
    model.reset_parameters(g)
    return model


def allocate_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   device: Device = None) -> dict:
    """Zeroed decode caches of ``seq_len`` slots, shaped by
    ``registry.cache_shapes``."""
    dev = resolve_device(device)
    return {stack: {name: torch.zeros(shape, dtype=dt, device=dev)
                    for name, (shape, dt) in leaves.items()}
            for stack, leaves in registry.cache_shapes(cfg, batch,
                                                       seq_len).items()}


def forward(model: Transformer, tokens: torch.Tensor,
            cond: Optional[torch.Tensor] = None, want_cache: bool = False,
            remat: Optional[bool] = None):
    """Full-sequence forward.  Returns ``(logits_physical [B, S, Vpad], aux,
    caches or None)``, the caches S slots long."""
    caches = (allocate_cache(model.cfg, tokens.shape[0], tokens.shape[1],
                             model.device) if want_cache else None)
    logits, aux = model(tokens, cond, caches=caches, remat=remat)
    return logits, aux, caches


def loss_fn(model: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor, cond: Optional[torch.Tensor] = None,
            remat: Optional[bool] = None):
    """Masked mean cross-entropy over the physical logits plus
    ``router_aux_weight`` times the MoE load-balance loss.  Returns
    ``(loss, {"xent", "aux"})``."""
    logits, aux = model(tokens, cond, remat=remat)
    xent = softmax_xent_physical(logits, targets, model.layout, mask)
    loss = xent + model.cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux}


def prefill(model: Transformer, tokens: torch.Tensor,
            cond: Optional[torch.Tensor] = None,
            caches: Optional[dict] = None):
    """Returns ``(last-position logits [B, Vpad], caches)``.  The head runs
    on the last position only (the reference computes every position's
    logits and keeps the last: the same values).  ``caches`` defaults to a
    new one of S_prompt slots; the engine passes its ``max_seq`` one."""
    if caches is None:
        caches = allocate_cache(model.cfg, tokens.shape[0], tokens.shape[1],
                                model.device)
    logits, _ = model(tokens, cond, caches=caches, head_at=slice(-1, None),
                      remat=False)
    return logits[:, 0], caches


def decode_step(model: Transformer, token: torch.Tensor, caches: dict,
                pos: int, cond: Optional[torch.Tensor] = None):
    """One decode step.  Returns ``(logits [B, Vpad], caches)``, the caches
    updated in place."""
    return model.decode_step(token, caches, pos, cond), caches
