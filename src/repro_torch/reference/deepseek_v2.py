"""DeepSeek-V2-Lite's training step, written plainly: the forward pass, the
loss (cross-entropy plus the sequence-wise balance loss), its gradients by
autograd and one AdamW update, in float32 with TF32 off.

It follows the DeepSeek-V2 paper (arXiv:2405.04434) and the published
``config.json`` (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite):
RMSNorm before attention and before the FFN; multi-head latent attention
without query compression (16 heads, each 128 dimensions without RoPE and
64 with it, values of 128, a 512-wide latent of the keys and values under
its own RMSNorm), YaRN on the RoPE part, causal softmax attention scaled by
``192 ** -0.5 * mscale(40, 0.707) ** 2``; a dense SwiGLU FFN in the leading
layer; in the others 64 routed SwiGLU experts under a float32 softmax
router whose top-6 probabilities are the gates as they are (not
renormalised, scaled by 1), beside 2 shared experts (one SwiGLU of twice
the width); a final RMSNorm and an untied head.  The balance loss is the
paper's expert-level one computed per sequence (``seq_aux``): ``E / (S k)
sum_i count_i P_i`` of each sequence, averaged over the sequences, summed
over the expert layers, weighted by ``alpha``.

It computes one device's share of an expert-parallel deployment, as the
program under test does: ``held`` of each layer's experts, experts ``e =
rank (mod E / held)``, the router still over all ``E``; only the held
experts' part of the routed output is added (the others' lies on other
devices); the vocabulary is the rows it is given.

Departures from the published model, each also where it is computed:

* the RoPE layout: the published code de-interleaves the 64 RoPE
  dimensions (pairs ``(2i, 2i + 1)`` become ``(i, i + 32)``) before it
  rotates halves; here they rotate as halves as they come.  The two are
  the same model up to a fixed permutation of the RoPE columns of each
  head in ``wq`` and of ``w_dkv``;
* the RMSNorm weight is kept as ``scale`` with the weight ``1 + scale``
  (initially 0), so weight decay pulls the weight toward 1;
* ``alpha``, the balance loss's weight, is not in the published keys; the
  configuration assumes it.

No cache, no batching tricks, no kernels: a batch is computed sequence by
sequence, each sequence's attention over its whole score matrix.  The
parameters are a dict named and laid out as the program's (``x @ w``,
``[d_in, d_out]``; the experts ``[held, d_in, d_out]``), so that a state
carries over by name.  ``dtype`` (the control) rounds both operands of
every product to that dtype, each tensor scaled by its largest magnitude
first (the forward only; the gradients stay float32).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

F32 = torch.float32
Params = Dict[str, torch.Tensor]


class Config(NamedTuple):
    layers: int
    dense_layers: int
    d_model: int
    heads: int
    nope: int
    rope: int
    v_dim: int
    kv_rank: int
    dense_ff: int
    expert_ff: int
    experts: int            # the router's outputs
    held: int               # the experts this device holds
    rank: int
    shared: int
    top_k: int
    vocab: int
    eps: float
    theta: float
    yarn_factor: float
    yarn_original: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    alpha: float


def config_of(keys: dict, published: dict, alpha: float,
              rank: int = 0) -> Config:
    """The share that ``keys`` (the published ``config.json`` keys, with
    the cut ones cut: ``n_routed_experts`` the experts held) describes;
    ``published`` holds the cut keys' published values (the router's
    width among them)."""
    rs = keys["rope_scaling"]
    return Config(
        layers=keys["num_hidden_layers"],
        dense_layers=keys["first_k_dense_replace"],
        d_model=keys["hidden_size"], heads=keys["num_attention_heads"],
        nope=keys["qk_nope_head_dim"], rope=keys["qk_rope_head_dim"],
        v_dim=keys["v_head_dim"], kv_rank=keys["kv_lora_rank"],
        dense_ff=keys["intermediate_size"],
        expert_ff=keys["moe_intermediate_size"],
        experts=published.get("n_routed_experts", keys["n_routed_experts"]),
        held=keys["n_routed_experts"], rank=rank,
        shared=keys["n_shared_experts"], top_k=keys["num_experts_per_tok"],
        vocab=keys["vocab_size"], eps=keys["rms_norm_eps"],
        theta=float(keys["rope_theta"]), yarn_factor=float(rs["factor"]),
        yarn_original=int(rs["original_max_position_embeddings"]),
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]),
        mscale_all_dim=float(rs["mscale_all_dim"]), alpha=alpha)


def _log(x: float) -> float:
    return float(torch.log(torch.tensor(x, dtype=torch.float64)))


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * _log(factor) + 1.0


def yarn(cfg: Config, device=None) -> Tuple[torch.Tensor, float, float]:
    """YaRN's inverse frequencies of the RoPE part ``[rope / 2]``, the
    factor on cos and sin, and the factor on the softmax scale."""
    dim, base = cfg.rope, cfg.theta
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=F32,
                                        device=device) / dim)
    inter = extra / cfg.yarn_factor

    def corr_dim(rot: float) -> float:
        return dim * _log(cfg.yarn_original / (rot * 2 * torch.pi)) / (
            2 * _log(base))

    low = max(int(torch.floor(torch.tensor(corr_dim(cfg.beta_fast)))), 0)
    high = min(int(torch.ceil(torch.tensor(corr_dim(cfg.beta_slow)))),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp                 # 1: keep the original frequency
    inv = inter * (1 - mask) + extra * mask
    every = yarn_mscale(cfg.yarn_factor, cfg.mscale_all_dim)
    return (inv, yarn_mscale(cfg.yarn_factor, cfg.mscale) / every,
            every * every)


class _Plain:
    """The products, in float32 or (the control) on operands rounded to
    ``dtype``."""

    def __init__(self, dtype: Optional[torch.dtype]):
        self.dtype = dtype

    def r(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None or x.numel() == 0:
            return x
        top = x.detach().abs().max()
        if float(top) == 0.0:
            return x
        s = top / torch.finfo(self.dtype).max
        low = (x.detach() / s).to(self.dtype).to(F32) * s
        return x + (low - x.detach())

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(a) @ self.r(b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def rotate(x: torch.Tensor, positions: torch.Tensor, inv: torch.Tensor,
           cs: float) -> torch.Tensor:
    """RoPE of ``x [S, H, D]`` as two halves (see the layout departure)."""
    ang = positions[:, None].to(F32) * inv                  # [S, D/2]
    cos, sin = torch.cos(ang)[:, None] * cs, torch.sin(ang)[:, None] * cs
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(p: Params, pre: str, h: torch.Tensor, cfg: Config,
              ops: _Plain, rope) -> torch.Tensor:
    """MLA of one sequence ``h [S, D]``."""
    s = h.shape[0]
    inv, cs, mult = rope
    pos = torch.arange(s, device=h.device)
    q = ops.mm(h, p[pre + "wq"]).view(s, cfg.heads, cfg.nope + cfg.rope)
    qn, qr = q[..., :cfg.nope], rotate(q[..., cfg.nope:], pos, inv, cs)
    c = ops.mm(h, p[pre + "w_dkv"])
    ckv = rms_norm(c[:, :cfg.kv_rank], p[pre + "kv_norm.scale"], cfg.eps)
    kr = rotate(c[:, None, cfg.kv_rank:], pos, inv, cs)     # [S, 1, rope]
    kn = ops.mm(ckv, p[pre + "w_uk"]).view(s, cfg.heads, cfg.nope)
    v = ops.mm(ckv, p[pre + "w_uv"]).view(s, cfg.heads, cfg.v_dim)
    q = torch.cat([qn, qr], -1).transpose(0, 1)             # [H, S, 192]
    k = torch.cat([kn, kr.expand(s, cfg.heads, cfg.rope)], -1).transpose(0, 1)
    scores = ops.mm(q, k.transpose(1, 2)) * (
        (cfg.nope + cfg.rope) ** -0.5 * mult)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = ops.mm(probs, v.transpose(0, 1)).transpose(0, 1).reshape(s, -1)
    return ops.mm(o, p[pre + "wo"])


def swiglu(x, w_gate, w_up, w_down, ops: _Plain) -> torch.Tensor:
    g = ops.mm(x, w_gate)
    return ops.mm(g * torch.sigmoid(g) * ops.mm(x, w_up), w_down)


def experts(p: Params, pre: str, h: torch.Tensor, cfg: Config,
            ops: _Plain) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE of one sequence: this device's routed experts' part plus
    the shared experts, and the sequence's balance loss."""
    s = h.shape[0]
    probs = torch.softmax(ops.mm(h, p[pre + "router"]), -1)    # [S, E]
    gates, ids = torch.topk(probs, cfg.top_k, -1)
    count = torch.zeros(cfg.experts, device=h.device).index_add_(
        0, ids.reshape(-1), torch.ones(ids.numel(), device=h.device))
    aux = cfg.experts * (count / (s * cfg.top_k) * probs.mean(0)).sum()
    out = torch.zeros_like(h)
    stride = cfg.experts // cfg.held
    for j in range(cfg.held):
        tok, slot = torch.nonzero(ids == cfg.rank + j * stride,
                                  as_tuple=True)
        y = swiglu(h[tok], p[pre + "experts.w_gate"][j],
                   p[pre + "experts.w_up"][j], p[pre + "experts.w_down"][j],
                   ops)
        out = out.index_add(0, tok, y * gates[tok, slot][:, None])
    out = out + swiglu(h, p[pre + "shared.w_gate"], p[pre + "shared.w_up"],
                       p[pre + "shared.w_down"], ops)
    return out, aux


def layer_names(cfg: Config):
    """Each layer's parameter prefix and whether it is a dense one, in
    the order they run."""
    return ([(f"dense_blocks.{i}.", True) for i in range(cfg.dense_layers)]
            + [(f"blocks.{i}.", False)
               for i in range(cfg.layers - cfg.dense_layers)])


def forward(p: Params, tokens: torch.Tensor, cfg: Config,
            ops: Optional[_Plain] = None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """One sequence ``tokens [S]`` -> ``(logits [S, V], the balance losses
    of its expert layers, summed)``."""
    ops = ops or _Plain(None)
    rope = yarn(cfg, tokens.device)
    x = p["embed.table"][tokens].to(F32)
    aux = torch.zeros((), device=x.device)
    for pre, dense in layer_names(cfg):
        x = x + attention(p, pre + "attn.",
                          rms_norm(x, p[pre + "ln1.scale"], cfg.eps), cfg,
                          ops, rope)
        h = rms_norm(x, p[pre + "ln2.scale"], cfg.eps)
        if dense:
            x = x + swiglu(h, p[pre + "mlp.w_gate"], p[pre + "mlp.w_up"],
                           p[pre + "mlp.w_down"], ops)
        else:
            y, a = experts(p, pre + "moe.", h, cfg, ops)
            x, aux = x + y, aux + a
    x = rms_norm(x, p["final_norm.scale"], cfg.eps)
    return ops.mm(x, p["lm_head.table"].T), aux


def loss_and_grads(params: Params, tokens: torch.Tensor,
                   targets: torch.Tensor, cfg: Config,
                   dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, Params]:
    """The batch's loss, the mean cross-entropy over its ``B * S`` targets
    plus ``alpha`` times the balance losses averaged over its ``B``
    sequences, and its float32 gradient, sequence by sequence."""
    ops = _Plain(dtype)
    leaves = {n: t.detach().to(F32).requires_grad_() for n, t in
              params.items()}
    b, s = tokens.shape
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for i in range(b):
        logits, aux = forward(leaves, tokens[i], cfg, ops)
        nll = torch.logsumexp(logits, -1) - logits.gather(
            1, targets[i][:, None].to(torch.int64))[:, 0]
        loss = nll.sum() / (b * s) + cfg.alpha * aux / b
        loss.backward()
        total += loss.detach().double()
    return total.to(F32), {n: t.grad for n, t in leaves.items()}


def decays(name: str, t: torch.Tensor) -> bool:
    """AdamW's weight decay takes every leaf of two or more dims and every
    layer's leaf (its norm scales among them), not the final norm."""
    return t.dim() >= 2 or name.startswith(("blocks.", "dense_blocks."))


def adamw(params: Params, grads: Params, m: Params, v: Params, step: int,
          opt: dict) -> Params:
    """One AdamW step from step count ``step`` (before it): the gradient
    clipped to global norm ``clip``, the warmup-cosine learning rate, the
    bias-corrected moments, decoupled weight decay; each new parameter
    rounded to its stored dtype.  ``opt``: ``lr``, ``weight_decay``,
    ``beta1``, ``beta2``, ``eps``, ``warmup``, ``total``, ``clip``.
    Returns the new parameters, float32."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(opt["clip"] / torch.clamp(norm, min=1e-9), max=1.0)
    t = torch.tensor(float(step + 1), dtype=F32)
    warm = torch.clamp(t / max(opt["warmup"], 1), max=1.0)
    prog = torch.clamp((t - opt["warmup"])
                       / max(opt["total"] - opt["warmup"], 1), 0.0, 1.0)
    lr = opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + torch.cos(torch.pi
                                                             * prog)))
    c1 = 1 - torch.pow(torch.tensor(opt["beta1"], dtype=F32), t)
    c2 = 1 - torch.pow(torch.tensor(opt["beta2"], dtype=F32), t)
    out = {}
    for n, p in params.items():
        g = grads[n] * scale.to(grads[n].device)
        m1 = opt["beta1"] * m[n] + (1 - opt["beta1"]) * g
        v1 = opt["beta2"] * v[n] + (1 - opt["beta2"]) * g * g
        delta = (m1 / c1.to(g.device)) / (torch.sqrt(v1 / c2.to(g.device))
                                          + opt["eps"])
        p32 = p.to(F32)
        if decays(n, p):
            delta = delta + opt["weight_decay"] * p32
        out[n] = (p32 - lr.to(g.device) * delta).to(p.dtype).to(F32)
    return out


def train_step(params: Params, m: Params, v: Params, step: int,
               tokens: torch.Tensor, targets: torch.Tensor, cfg: Config,
               opt: dict, dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, Params, Params]:
    """``(loss, gradients, new parameters)`` of one training step from
    ``params`` (in their stored dtype), the moments ``m`` and ``v`` and
    the step count ``step``, with TF32 off."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss, grads = loss_and_grads(params, tokens, targets, cfg, dtype)
        with torch.no_grad():
            new = adamw(params, grads, m, v, step, opt)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
    return loss, grads, new
