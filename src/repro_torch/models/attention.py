"""Attention: GQA, sliding-window, MLA (DeepSeek latent), cross-attention.

The twin of the JAX package's ``models/attention.py``, in plain tensor
operations as the reference is in XLA operations (no library attention
kernel).  Prefill runs **chunked online-softmax attention**: the [Tq, Tk]
score matrix is never built, only [q_chunk, kv_chunk] tiles with running
(max, sum, acc) statistics, and tiles that the mask empties entirely are
never visited (the causal upper triangle, and for a sliding-window layer
all but a band of kv chunks).  Decode scores one query against the cache.

Scores and softmax are float32 whatever the operands' dtype (the
reference's ``preferred_element_type=jnp.float32``): on the card a bf16
product is a cuBLAS ``bmm`` with a float32 output, so no float32 copy of
the cache is made.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (RMSNorm, apply_rope, dtype_of,
                                       normal_, param)

_NEG = -1e30
_EMPTY = 2 ** 30         # position of a padded kv slot: always masked


class _BmmF32(torch.autograd.Function):
    """The batched product of two bf16/fp16 operands, in float32.

    Forward: on the card the operands stay in their dtype and cuBLAS writes
    float32 (no float32 copy of a cache); the CPU has no such product, so
    they are widened first.  ``torch.bmm(..., out_dtype=...)`` has no
    autograd formula, hence this function.  Backward: the float32
    ``grad_out`` times the other operand widened to float32 (a tile of the
    chunked core, never a cache), each gradient rounded to its operand's
    dtype -- the arithmetic of the reference's ``einsum`` with
    ``preferred_element_type=float32`` and of the CPU path's widening."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.to(torch.float32), b.to(torch.float32))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(grad, b.to(torch.float32).transpose(1, 2)
                           ).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.to(torch.float32).transpose(1, 2), grad
                           ).to(b.dtype)
        return ga, gb


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, accumulated and returned in float32, with a
    backward (``_BmmF32``) for bf16/fp16 operands."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    return _BmmF32.apply(a, b)


# ---------------------------------------------------------------------------
# Chunked online-softmax attention core
# ---------------------------------------------------------------------------

def kv_chunk_ranges(n_q: int, n_k: int, qc: int, kc: int, *, causal: bool,
                    window: int):
    """The kv chunks each q chunk visits (the reference's static bounds):
    a band of ``(qc + window - 2) // kc + 2`` chunks for a causal window
    layer (its rows reach back ``window - 1`` slots); for a
    global causal layer with at least 8 q chunks, up to 4 groups of q
    chunks each bounded by its last row's causal end; else all."""
    if causal and window > 0:
        band = min(n_k, (qc + window - 2) // kc + 2)
        return [range(s, s + band) for s in
                (min(max((qi * qc - window + 1) // kc, 0), n_k - band)
                 for qi in range(n_q))]
    if causal and n_q >= 8:
        group = -(-n_q // 4)
        out = []
        for lo in range(0, n_q, group):
            hi = min(lo + group, n_q)
            end = min(n_k, (hi * qc - 1) // kc + 1)
            out += [range(end)] * (hi - lo)
        return out
    return [range(n_k)] * n_q


def _attend_chunked(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                    q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """q: [B, Tq, KV, G, hd]; k, v: [B, Tk, KV, hd].
    Positions are int [Tq] / [Tk] (aligned aranges for self-attention).
    Returns [B, Tq, KV, G, hd] in q's dtype."""
    b, tq, nkv, g, hd = q.shape
    tk = k.shape[1]
    scale = hd ** -0.5
    qc = min(q_chunk, tq)
    kc = min(kv_chunk, tk)
    n_q = -(-tq // qc)
    n_k = -(-tk // kc)
    pad_q = n_q * qc - tq
    pad_k = n_k * kc - tk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad_k), value=_EMPTY)

    outs = []
    for qi, kv_range in enumerate(kv_chunk_ranges(n_q, n_k, qc, kc,
                                                  causal=causal,
                                                  window=window)):
        qs = q[:, qi * qc:(qi + 1) * qc]
        qp = q_pos[qi * qc:(qi + 1) * qc]
        qm = qs.permute(0, 2, 3, 1, 4).reshape(b * nkv, g * qc, hd)
        m = torch.full((b, nkv, g, qc), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, nkv, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, nkv, g, qc, hd), dtype=torch.float32,
                          device=q.device)
        for ki in kv_range:
            ks = k[:, ki * kc:(ki + 1) * kc]
            vs = v[:, ki * kc:(ki + 1) * kc]
            kp = kv_pos[ki * kc:(ki + 1) * kc]
            km = ks.permute(0, 2, 3, 1).reshape(b * nkv, hd, kc)
            s = _bmm_f32(qm, km).view(b, nkv, g, qc, kc) * scale
            # padded kv slots carry position 2**30: always masked, even in
            # the non-causal global path (cross-attention)
            ok = (kp[None, :] < 2 ** 29)
            if causal:
                ok = ok & (kp[None, :] <= qp[:, None])
            if window > 0:
                ok = ok & (qp[:, None] - kp[None, :] < window)
            s = torch.where(ok, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(s > _NEG / 2, p, 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            vm = vs.permute(0, 2, 1, 3).reshape(b * nkv, kc, hd)
            pv = _bmm_f32(p.to(vs.dtype).reshape(b * nkv, g * qc, kc), vm)
            acc = acc * corr[..., None] + pv.view(b, nkv, g, qc, hd)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))   # [B, qc, KV, G, hd]
    return torch.cat(outs, dim=1)[:, :tq].to(q.dtype)


def _attend_decode(q, k, v, kv_pos, pos, window: int) -> torch.Tensor:
    """One-token decode: q [B, 1, KV, G, hd] vs cache k/v [B, S, KV, hd].
    ``kv_pos`` [S] marks each cache slot's position; ``pos`` is the query's.
    K and V stay in the cache dtype; the products accumulate in float32."""
    b, _, nkv, g, hd = q.shape
    s_len = k.shape[1]
    qm = q.reshape(b * nkv, g, hd)
    km = k.permute(0, 2, 3, 1).reshape(b * nkv, hd, s_len)
    s = _bmm_f32(qm, km).view(b, nkv, g, s_len) * hd ** -0.5
    ok = kv_pos <= pos
    if window > 0:
        ok = ok & (pos - kv_pos < window)
    s = torch.where(ok, s, _NEG)
    p = torch.softmax(s, dim=-1)
    vm = v.permute(0, 2, 1, 3).reshape(b * nkv, s_len, hd)
    out = _bmm_f32(p.to(v.dtype).reshape(b * nkv, g, s_len), vm)
    return out.view(b, 1, nkv, g, hd).to(q.dtype)


def live_range(pos: int, window: int) -> Tuple[int, int]:
    """The cache slots a decode query at ``pos`` can see: ``[lo, pos]``.
    Every other slot is masked to ``_NEG``, whose softmax weight is exactly
    0 in float32, so attending over this range alone is the same function
    as attending over the whole cache."""
    lo = max(0, pos - window + 1) if window > 0 else 0
    return lo, pos + 1


def _write_slot(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``cache[:, pos] = new[:, 0]`` in the cache's dtype (the reference's
    ``dynamic_update_slice``, in place)."""
    cache[:, pos] = new[:, 0].to(cache.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention (prefill / decode)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Standard (non-MLA) attention weights.  ``kv_input_dim`` overrides the
    K/V input dimension for cross-attention (conditioning stream)."""

    def __init__(self, cfg: ModelConfig, *, kv_input_dim: int = 0,
                 device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim_
        dkv = kv_input_dim or d
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.wq = param((d, h * hd), dt, device)
        self.wk = param((dkv, kv * hd), dt, device)
        self.wv = param((dkv, kv * hd), dt, device)
        self.wo = param((h * hd, d), dt, device)
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, w.shape[0] ** -0.5, g)
        if self.cfg.use_qk_norm:
            self.q_norm.reset_parameters(g)
            self.k_norm.reset_parameters(g)

    def _split(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], n, self.cfg.head_dim_)

    def qkv(self, x, kv_in, positions: Optional[torch.Tensor],
            theta: float):
        """Projections (+ qk-norm, + RoPE when ``positions`` is given)."""
        cfg = self.cfg
        q = self._split(x @ self.wq, cfg.num_heads)
        k = self._split(kv_in @ self.wk, cfg.num_kv_heads)
        v = self._split(kv_in @ self.wv, cfg.num_kv_heads)
        if cfg.use_qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        if positions is not None:
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
        return q, k, v

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                window: int, theta: float):
        """Causal self-attention over a full sequence.  Returns
        ``(out, (k, v))`` so prefill can seed the cache."""
        cfg = self.cfg
        b, t, _ = x.shape
        kv, hd = cfg.num_kv_heads, cfg.head_dim_
        q, k, v = self.qkv(x, x, positions, theta)
        qg = q.reshape(b, t, kv, cfg.num_heads // kv, hd)
        out = _attend_chunked(qg, k, v, positions, positions, causal=True,
                              window=window, q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv)
        return out.reshape(b, t, cfg.num_heads * hd) @ self.wo, (k, v)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int, *, window: int,
               theta: float) -> torch.Tensor:
        """One decode step.  x: [B, 1, D]; cache k/v: [B, S, KV, hd],
        written at ``pos`` in place; attends over the live slots only."""
        cfg = self.cfg
        b = x.shape[0]
        kv, hd = cfg.num_kv_heads, cfg.head_dim_
        positions = torch.tensor([pos], dtype=torch.int64, device=x.device)
        q, k_new, v_new = self.qkv(x, x, positions, theta)
        _write_slot(cache_k, k_new, pos)
        _write_slot(cache_v, v_new, pos)
        lo, hi = live_range(pos, window)
        kv_pos = torch.arange(lo, hi, device=x.device)
        qg = q.reshape(b, 1, kv, cfg.num_heads // kv, hd)
        out = _attend_decode(qg, cache_k[:, lo:hi], cache_v[:, lo:hi],
                             kv_pos, pos, window)
        return out.reshape(b, 1, cfg.num_heads * hd) @ self.wo


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed latent KV cache + decoupled RoPE
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                         cfg.v_head_dim)
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.wq = param((d, h * (dn + dr)), dt, device)
        self.w_dkv = param((d, r + dr), dt, device)
        self.kv_norm = RMSNorm(r, cfg.norm_eps, device)
        self.w_uk = param((r, h * dn), dt, device)
        self.w_uv = param((r, h * dv), dt, device)
        self.wo = param((h * dv, d), dt, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        for w in (self.wq, self.w_dkv, self.w_uk, self.w_uv, self.wo):
            normal_(w, w.shape[0] ** -0.5, g)
        self.kv_norm.reset_parameters(g)

    def _q(self, x, positions):
        cfg = self.cfg
        h, dn, dr = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        q = (x @ self.wq).reshape(*x.shape[:-1], h, dn + dr)
        qn, qr = q[..., :dn], q[..., dn:]
        return qn, apply_rope(qr, positions, cfg.rope_theta)

    def _compress(self, x, positions):
        cfg = self.cfg
        r = cfg.kv_lora_rank
        c = x @ self.w_dkv
        ckv = self.kv_norm(c[..., :r])
        krope = apply_rope(c[..., None, r:], positions,
                           cfg.rope_theta)[..., 0, :]
        return ckv, krope

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor):
        """Prefill MLA: expand the latent into per-head K/V and run the
        chunked core.  Returns ``(out, (ckv, krope))``: the cache stores only
        the (r + dr)-dim latent per token."""
        cfg = self.cfg
        b, t, _ = x.shape
        h = cfg.num_heads
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        qn, qr = self._q(x, positions)
        ckv, krope = self._compress(x, positions)
        k_nope = (ckv @ self.w_uk).reshape(b, t, h, dn)
        val = (ckv @ self.w_uv).reshape(b, t, h, dv)
        q = torch.cat([qn, qr], dim=-1)                      # [B,T,H,dn+dr]
        k = torch.cat([k_nope, krope[:, :, None, :].expand(b, t, h, dr)],
                      dim=-1)
        # pad V up to the qk head dim so the shared core can run, slice after
        vp = torch.nn.functional.pad(val, (0, (dn + dr) - dv))
        out = _attend_chunked(q[:, :, :, None, :], k, vp, positions,
                              positions, causal=True, window=0,
                              q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv)
        out = out[..., 0, :dv].reshape(b, t, h * dv) @ self.wo
        return out, (ckv, krope)

    def decode(self, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, pos: int) -> torch.Tensor:
        """Absorbed-matmul MLA decode: scores and context in the latent
        space, so a step costs O(S * (r + dr)) whatever the head count.

          scores[b,h,s] = (q_nope[b,h] @ W_uk[h]) . ckv[b,s] + q_rope[b,h] . krope[b,s]
          ctx[b,h]      = (sum_s p[b,h,s] ckv[b,s]) @ W_uv[h]
        """
        cfg = self.cfg
        b = x.shape[0]
        h, r = cfg.num_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        positions = torch.tensor([pos], dtype=torch.int64, device=x.device)
        qn, qr = self._q(x, positions)
        ckv_new, krope_new = self._compress(x, positions)
        _write_slot(cache_ckv, ckv_new, pos)
        _write_slot(cache_krope, krope_new, pos)
        f32 = torch.float32
        ckv = cache_ckv[:, :pos + 1].to(f32)
        krope = cache_krope[:, :pos + 1].to(f32)
        w_uk = self.w_uk.reshape(r, h, dn).to(f32)
        w_uv = self.w_uv.reshape(r, h, dv).to(f32)
        q_eff = torch.einsum("bqhd,rhd->bhr", qn.to(f32), w_uk)  # absorb W_uk
        scores = (torch.einsum("bhr,bsr->bhs", q_eff, ckv)
                  + torch.einsum("bqhd,bsd->bhs", qr.to(f32), krope))
        p = torch.softmax(scores * (dn + dr) ** -0.5, dim=-1)
        ctx_lat = torch.einsum("bhs,bsr->bhr", p, ckv)
        ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv)
        return ctx.reshape(b, 1, h * dv).to(x.dtype) @ self.wo


# ---------------------------------------------------------------------------
# Cross-attention (llama-3.2-vision gated layers / musicgen conditioning)
# ---------------------------------------------------------------------------

class CrossAttention(Attention):
    """Queries from the text stream, K/V from the (stubbed) frontend
    embeddings; no causality, no RoPE; tanh-gated (llama-vision style)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, kv_input_dim=cfg.cond_dim_, device=device)
        self.gate = param((), torch.float32, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        super().reset_parameters(g)
        nn.init.zeros_(self.gate)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        kv, hd = cfg.num_kv_heads, cfg.head_dim_
        q, k, v = self.qkv(x, cond.to(x.dtype), None, 0.0)
        qg = q.reshape(b, t, kv, cfg.num_heads // kv, hd)
        qpos = torch.arange(t, device=x.device)
        kpos = torch.arange(cond.shape[1], device=x.device)
        out = _attend_chunked(qg, k, v, qpos, kpos, causal=False, window=0,
                              q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv)
        out = out.reshape(b, t, cfg.num_heads * hd) @ self.wo
        return torch.tanh(self.gate).to(x.dtype) * out
