"""Attention: GQA, sliding-window, MLA (DeepSeek latent), cross-attention.

The twin of the JAX package's ``models/attention.py``, in plain tensor
operations as the reference is in XLA operations (no library attention
kernel), but for MLA's causal core on the card (``mla_attention``: a
hand-written fused kernel in bf16 and fp16, ``kernels/mla_attention.py``).
Prefill runs **chunked online-softmax attention**: the [Tq, Tk]
score matrix is never built, only [q_chunk, kv_chunk] tiles with running
(max, sum, acc) statistics, and tiles that the mask empties entirely are
never visited (the causal upper triangle, and for a sliding-window layer
all but a band of kv chunks).  Decode scores one query against the cache.

Scores and softmax are float32 whatever the operands' dtype (the
reference's ``preferred_element_type=jnp.float32``): on the card a bf16
product is a cuBLAS ``bmm`` with a float32 output, so no float32 copy of
the cache is made.

**On a mesh** the split is chosen from ``cfg`` and the mesh alone
(``attn_split``):

  * ``"heads"`` -- the column blocks of ``wq``/``wk``/``wv`` hold whole
    heads (KV heads tile the model axis; MLA: query heads do): each rank
    attends with its own heads, its cache holds their K/V, and the
    row-parallel ``wo`` is followed by a model all-reduce;
  * ``"gather"`` -- they do not: each rank all-gathers the weight blocks
    per use and attends with every head, its cache holding all KV heads.

The **sequence-parallel prefill** runs under the reference's own
condition (``seq_parallel_attn``, by default ``model_size % kv != 0``,
with ``t % model_size == 0``): each rank computes its ``t / M`` query
positions with every head, against K/V all-gathered over the model axis,
and the outputs are all-gathered along the sequence.  MLA keeps ``w_dkv``
replicated, so every model rank holds the whole latent cache of its batch
slice, and decodes with the absorbed product per local head.

The backward (training) follows from who computes what: in ``"heads"``
mode the replicated input (MLA: the input of ``wq`` and the latent)
enters the rank's heads through ``layers.model_copy``, and a replicated
qk-norm scale used on them too; in ``"gather"`` mode every rank computes
the same, so a gathered weight's gradient is already whole there; in the
sequence-parallel prefill every rank works on its own positions, so the
input is copied, the gathered weights and K/V reduce-scatter their
gradients, and the output's gather keeps the rank's block.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import mla_attention as _fused
from repro_torch.models.layers import (RMSNorm, _bmm_f32, apply_rope, block,
                                       dtype_of, full_shape, lse_combine,
                                       model_copy, model_gather, normal_,
                                       param, rms_norm, rope_for,
                                       row_parallel)
from repro_torch.obs import marks
from repro_torch.sharding.specs import SINGLE, MeshCtx

_NEG = -1e30
_EMPTY = 2 ** 30         # position of a padded kv slot: always masked


# ---------------------------------------------------------------------------
# Chunked online-softmax attention core
# ---------------------------------------------------------------------------

def kv_chunk_ranges(n_q: int, n_k: int, qc: int, kc: int, *, causal: bool,
                    window: int, q_offset: int = 0):
    """The kv chunks each q chunk visits (the reference's static bounds):
    a band of ``(qc + window - 2) // kc + 2`` chunks for a causal window
    layer (its rows reach back ``window - 1`` slots); for a
    global causal layer with at least 8 q chunks, up to 4 groups of q
    chunks each bounded by its last row's causal end; else all.  The
    queries sit at positions ``q_offset + i`` (a sequence-parallel rank's
    block); a tile the mask empties adds exactly nothing, so bounds that
    cover every live tile give the same rows."""
    if causal and window > 0:
        band = min(n_k, (qc + window - 2) // kc + 2)
        return [range(s, s + band) for s in
                (min(max((q_offset + qi * qc - window + 1) // kc, 0),
                     n_k - band) for qi in range(n_q))]
    if causal and n_q >= 8:
        group = -(-n_q // 4)
        out = []
        for lo in range(0, n_q, group):
            hi = min(lo + group, n_q)
            end = min(n_k, (q_offset + hi * qc - 1) // kc + 1)
            out += [range(end)] * (hi - lo)
        return out
    return [range(n_k)] * n_q


def _attend_chunked(q, k, v, q_pos, kv_pos, *, causal: bool, window: int,
                    q_chunk: int, kv_chunk: int,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Tq, KV, G, hd]; k, v: [B, Tk, KV, hd].
    Positions are int [Tq] / [Tk] (aligned aranges for self-attention;
    the queries' start at ``q_offset``).  ``scale``: the scores' factor,
    ``hd ** -0.5`` by default.
    Returns [B, Tq, KV, G, hd] in q's dtype."""
    b, tq, nkv, g, hd = q.shape
    tk = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
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
                                                  window=window,
                                                  q_offset=q_offset)):
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


# ---------------------------------------------------------------------------
# MLA's causal core: the fused kernel on the card, the chunked core elsewhere
# ---------------------------------------------------------------------------

def _mla_attention_plain(q_nope, q_rope, k_nope, k_rope, v, scale: float, *,
                         q_chunk: int, kv_chunk: int) -> torch.Tensor:
    """The plain version: the whole query and key (``k_rope`` expanded to
    every head) and V padded to the query width, through the chunked
    core; returns [B, T, H, dv]."""
    b, t, h, dn = q_nope.shape
    dr, dv = q_rope.shape[-1], v.shape[-1]
    q = torch.cat([q_nope, q_rope], dim=-1)                 # [B,T,H,dn+dr]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, dr)],
                  dim=-1)
    # pad V up to the qk head dim so the shared core can run, slice after
    vp = torch.nn.functional.pad(v, (0, (dn + dr) - dv))
    pos = torch.arange(t, device=q.device)
    out = _attend_chunked(q[:, :, :, None, :], k, vp, pos, pos, causal=True,
                          window=0, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          scale=scale)
    return out[..., 0, :dv]


class _MLAFused(torch.autograd.Function):
    """The fused kernel (``kernels.mla_attention``) and its backward."""

    @staticmethod
    def forward(ctx, q_nope, q_rope, k_nope, k_rope, v, scale: float):
        save = any(ctx.needs_input_grad[:5])
        out, out32, lse = _fused.forward(q_nope, q_rope, k_nope, k_rope, v,
                                         scale, save)
        if save:
            ctx.save_for_backward(q_nope, q_rope, k_nope, k_rope, v, out32,
                                  lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, grad):
        marks.attention("bwd")
        return (*_fused.backward(grad, *ctx.saved_tensors, ctx.scale), None)


def _check_mla(q_nope, q_rope, k_nope, k_rope, v) -> None:
    if q_nope.dim() != 4:
        raise ValueError(f"mla_attention: q_nope must be [B, T, H, dn]; got "
                         f"shape {tuple(q_nope.shape)}")
    b, t, h, dn = q_nope.shape
    dr, dv = q_rope.shape[-1], v.shape[-1]
    want = {"q_nope": (b, t, h, dn), "q_rope": (b, t, h, dr),
            "k_nope": (b, t, h, dn), "k_rope": (b, t, dr),
            "v": (b, t, h, dv)}
    args = {"q_nope": q_nope, "q_rope": q_rope, "k_nope": k_nope,
            "k_rope": k_rope, "v": v}
    for name, x in args.items():
        if tuple(x.shape) != want[name]:
            raise ValueError(f"mla_attention: {name} must have shape "
                             f"{want[name]} beside q_nope "
                             f"{tuple(q_nope.shape)}; got {tuple(x.shape)}")
        if x.dtype != q_nope.dtype or x.device != q_nope.device:
            raise ValueError(f"mla_attention: {name} is {x.dtype} on "
                             f"{x.device}, q_nope {q_nope.dtype} on "
                             f"{q_nope.device}: all five must agree")
        if not x.is_contiguous():
            raise ValueError(f"mla_attention: {name} must be contiguous")
    if q_nope.dtype not in (torch.float32, *_fused.HALF):
        raise ValueError(f"mla_attention: no core for {q_nope.dtype}")


def mla_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                  k_nope: torch.Tensor, k_rope: torch.Tensor,
                  v: torch.Tensor, scale: float, *, q_chunk: int = 1024,
                  kv_chunk: int = 2048) -> torch.Tensor:
    """MLA's causal self-attention core: q_nope, k_nope [B, T, H, dn],
    q_rope [B, T, H, dr], k_rope [B, T, dr] (one RoPE key a token, shared
    by the heads), v [B, T, H, dv], one dtype, contiguous; scores
    ``scale * (q_nope . k_nope + q_rope . k_rope)``.  Returns [B, T, H, dv]
    in that dtype.

    Dispatch by what the input shows: bf16 or fp16 on the card launch the
    fused kernel (``kernels.mla_attention``), or raise; a float32 input,
    or one on the CPU, takes the plain version (``_attend_chunked``, with
    ``q_chunk`` and ``kv_chunk``)."""
    _check_mla(q_nope, q_rope, k_nope, k_rope, v)
    if q_nope.is_cuda and q_nope.dtype in _fused.HALF:
        dims = (q_nope.shape[-1], q_rope.shape[-1], v.shape[-1])
        if not _fused.supported(*dims):
            raise ValueError(f"mla_attention: the fused kernel is built for "
                             f"head parts (dn, dr, dv) {_fused.DIMS}; got "
                             f"{dims}")
        marks.attention("fwd")
        return _MLAFused.apply(q_nope, q_rope, k_nope, k_rope, v,
                               float(scale))
    marks.attention("chunked")
    return _mla_attention_plain(q_nope, q_rope, k_nope, k_rope, v, scale,
                                q_chunk=q_chunk, kv_chunk=kv_chunk)


def _softmax_part(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The softmax over the last dim of float32 scores of live slots alone,
    with its statistics: ``(m, l, p)``, the scores' max, the sum of
    ``exp(s - m)`` and ``p = exp(s - m) / l``.  With no slot (a
    sequence-sharded rank's empty part) ``m = -1e30``, ``l = 0`` and ``p``
    is empty, so its weighted sums are 0."""
    if s.shape[-1] == 0:
        return (torch.full(s.shape[:-1], _NEG, dtype=s.dtype,
                           device=s.device),
                s.new_zeros(s.shape[:-1]), s)
    m = s.amax(-1)
    e = torch.exp(s - m[..., None])
    l = e.sum(-1)
    return m, l, e / l[..., None]


def _attend_decode(q, k, v) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One-token decode over live slots alone: q [B, 1, KV, G, hd] vs k/v
    [B, n, KV, hd] (every slot live, ``n`` possibly 0).  K and V stay in
    the cache dtype; the products accumulate in float32.  Returns float32
    ``(m [B, KV, G], l, out [B, KV, G, hd])`` (``_softmax_part``'s
    statistics and the softmax-weighted values): the answer itself, or a
    data rank's part of a sequence-sharded cache for
    ``layers.lse_combine``."""
    b, _, nkv, g, hd = q.shape
    n = k.shape[1]
    qm = q.reshape(b * nkv, g, hd)
    km = k.permute(0, 2, 3, 1).reshape(b * nkv, hd, n)
    s = _bmm_f32(qm, km).view(b, nkv, g, n) * hd ** -0.5
    m, l, p = _softmax_part(s)
    if n == 0:
        return m, l, q.new_zeros((b, nkv, g, hd), dtype=torch.float32)
    vm = v.permute(0, 2, 1, 3).reshape(b * nkv, n, hd)
    out = _bmm_f32(p.to(v.dtype).reshape(b * nkv, g, n), vm)
    return m, l, out.view(b, nkv, g, hd)


def seq_block(cache: torch.Tensor, ctx: MeshCtx, lo: int, hi: int,
              seq_shard: bool = True) -> Tuple[int, int, int]:
    """The part of ``cache`` (slot dim 1) that a decode on this rank reads:
    the position of its first slot, ``base``, and the live range ``[lo,
    hi)`` clipped to it, as positions (empty, ``lo >= hi``, where none is
    live here).  Unsharded: the whole cache, ``base`` 0; sequence-sharded:
    this data rank's block."""
    if not seq_shard:
        return 0, lo, hi
    n = cache.shape[1]
    base = ctx.comm.data_idx * n
    lo = max(lo, base)
    return base, lo, max(lo, min(hi, base + n))


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

def attn_split(cfg: ModelConfig, m: int) -> str:
    """``"heads"`` where the model axis's column blocks hold whole heads
    (KV heads for GQA, query heads for MLA), else ``"gather"``."""
    n = cfg.num_heads if cfg.use_mla else cfg.num_kv_heads
    return "heads" if m == 1 or n % m == 0 else "gather"


def cache_kv_heads(cfg: ModelConfig, m: int) -> int:
    """KV heads a rank's cache holds on a model axis of ``m``."""
    return cfg.num_kv_heads // m if attn_split(cfg, m) == "heads" \
        else cfg.num_kv_heads


def seq_parallel(cfg: ModelConfig, ctx: MeshCtx, t: int) -> bool:
    """The reference's condition for the sequence-parallel prefill
    (``attention.py:244-252``): ``seq_parallel_attn``, by default
    ``model_size % kv != 0``, on a model axis above 1, with ``t > 1``
    positions that split over it."""
    m = ctx.model_size
    use = cfg.seq_parallel_attn
    if use is None:
        use = m % max(cfg.num_kv_heads, 1) != 0
    return bool(use) and ctx.comm is not None and m > 1 and t > 1 \
        and t % m == 0


class Attention(nn.Module):
    """Standard (non-MLA) attention weights.  ``kv_input_dim`` overrides the
    K/V input dimension for cross-attention (conditioning stream).  On a
    mesh each weight is this rank's block (columns of ``wq``/``wk``/``wv``,
    rows of ``wo``)."""

    def __init__(self, cfg: ModelConfig, *, kv_input_dim: int = 0,
                 device=None, ctx: MeshCtx = SINGLE):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim_
        dkv = kv_input_dim or d
        dt = dtype_of(cfg)
        m = ctx.model_size
        self.cfg, self.ctx = cfg, ctx
        # this rank attends with its own heads; in "gather" mode with all
        self.tp = m > 1 and attn_split(cfg, m) == "heads"
        self.wq = param((d, block(h * hd, m, "wq")), dt, device,
                        full=(d, h * hd))
        self.wk = param((dkv, block(kv * hd, m, "wk")), dt, device,
                        full=(dkv, kv * hd))
        self.wv = param((dkv, block(kv * hd, m, "wv")), dt, device,
                        full=(dkv, kv * hd))
        self.wo = param((block(h * hd, m, "wo"), d), dt, device,
                        full=(h * hd, d))
        if cfg.use_qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_(w, full_shape(w)[0] ** -0.5, g)
        if self.cfg.use_qk_norm:
            self.q_norm.reset_parameters(g)
            self.k_norm.reset_parameters(g)

    def weights(self, full: bool = False, replicated: bool = True):
        """``(wq, wk, wv, wo)`` as this rank computes with them: its
        blocks in ``"heads"`` mode, all-gathered over the model axis in
        ``"gather"`` mode or when ``full``.  ``replicated``: every rank
        computes the same with the gathered weights (their gradient is
        whole on each rank), else each its own positions (the
        sequence-parallel prefill: the gradient is reduce-scattered)."""
        w = (self.wq, self.wk, self.wv, self.wo)
        if self.tp and not full:
            return w
        return tuple(model_gather(t, self.ctx, 0 if i == 3 else 1,
                                  "weights", replicated)
                     for i, t in enumerate(w))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(*x.shape[:-1], -1, self.cfg.head_dim_)

    def _norm_rope(self, t, norm: str, positions, theta: float,
                   partial: bool = False):
        """qk-norm (``norm`` names it), then RoPE when ``positions`` is
        given.  ``partial``: ``t`` is this rank's part of the heads or
        positions, so the replicated norm scale's gradient is summed over
        the model ranks."""
        if self.cfg.use_qk_norm:
            mod = getattr(self, norm)
            scale = model_copy(mod.scale, self.ctx, "norm") if partial \
                else mod.scale
            t = rms_norm(t, scale, mod.eps)
        return t if positions is None else apply_rope(t, positions, theta)

    def qkv(self, x, kv_in, positions: Optional[torch.Tensor],
            theta: float, w=None):
        """Projections (+ qk-norm, + RoPE when ``positions`` is given),
        with this rank's heads (``weights()``) unless ``w`` is given.  In
        ``"heads"`` mode the replicated inputs enter the rank's columns
        (``model_copy``)."""
        wq, wk, wv, _ = self.weights() if w is None else w
        if self.tp:
            xq = model_copy(x, self.ctx, "attn_in")
            kv_in = xq if kv_in is x else model_copy(kv_in, self.ctx,
                                                     "attn_in")
            x = xq
        q = self._norm_rope(self._split(x @ wq), "q_norm", positions, theta,
                            self.tp)
        k = self._norm_rope(self._split(kv_in @ wk), "k_norm", positions,
                            theta, self.tp)
        return q, k, self._split(kv_in @ wv)

    def _out(self, out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        """Heads -> d_model; row-parallel in ``"heads"`` mode."""
        out = out.reshape(*out.shape[:2], -1)
        return row_parallel(out, wo, self.ctx, "attn") if self.tp \
            else out @ wo

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                window: int, theta: float):
        """Causal self-attention over a full sequence.  Returns
        ``(out, (k, v))`` so prefill can seed the cache (this rank's KV
        heads)."""
        cfg = self.cfg
        b, t, _ = x.shape
        if seq_parallel(cfg, self.ctx, t):
            return self._forward_seq_parallel(x, positions, window, theta)
        w = self.weights()
        q, k, v = self.qkv(x, x, positions, theta, w)
        nkv = k.shape[2]
        qg = q.reshape(b, t, nkv, q.shape[2] // nkv, cfg.head_dim_)
        out = _attend_chunked(qg, k, v, positions, positions, causal=True,
                              window=window, q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv)
        return self._out(out, w[3]), (k, v)

    def _forward_seq_parallel(self, x, positions, window: int, theta: float):
        """This rank's ``t / M`` query positions with every head, against
        every position's K/V (all-gathered over the model axis); the
        outputs all-gathered along the sequence.  The cache entry is this
        rank's KV heads, as in the head-parallel path."""
        cfg, ctx = self.cfg, self.ctx
        b, t, _ = x.shape
        m, i = ctx.model_size, ctx.comm.model_idx
        c = t // m
        # every rank's gradients here are partial (its positions; in
        # "heads" mode its K/V heads): sums over the model ranks
        x = model_copy(x, ctx, "attn_in")
        if self.tp:
            wq = model_gather(self.wq, ctx, 1, "weights", False)
            wo = model_gather(self.wo, ctx, 0, "weights", False)
            wk, wv = self.wk, self.wv
        else:
            wq, wk, wv, wo = self.weights(replicated=False)
        k = self._norm_rope(self._split(x @ wk), "k_norm", positions, theta,
                            True)
        v = self._split(x @ wv)
        k_all, v_all = k, v
        if self.tp:
            k_all = model_gather(k, ctx, 2, "kv", False)
            v_all = model_gather(v, ctx, 2, "kv", False)
        pos_q = positions[i * c:(i + 1) * c]
        q = self._norm_rope(self._split(x[:, i * c:(i + 1) * c] @ wq),
                            "q_norm", pos_q, theta, True)
        kv = cfg.num_kv_heads
        qg = q.reshape(b, c, kv, cfg.num_heads // kv, cfg.head_dim_)
        out = _attend_chunked(qg, k_all, v_all, pos_q, positions,
                              causal=True, window=window,
                              q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv, q_offset=i * c)
        out = out.reshape(b, c, -1) @ wo
        return model_gather(out, ctx, 1, "seq"), (k, v)

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, pos: int, *, window: int,
               theta: float, seq_shard: bool = False) -> torch.Tensor:
        """One decode step.  x: [B, 1, D]; cache k/v: [B, S, KV, hd] (this
        rank's KV heads), written at ``pos`` in place; attends over the
        live slots only.  ``seq_shard``: the cache is this data rank's
        block of the sequence (``seq_block``): the rank that owns slot
        ``pos`` writes it, each attends over its live slots and the parts
        meet in ``layers.lse_combine``."""
        cfg = self.cfg
        b = x.shape[0]
        hd = cfg.head_dim_
        positions = torch.tensor([pos], dtype=torch.int64, device=x.device)
        w = self.weights()
        q, k_new, v_new = self.qkv(x, x, positions, theta, w)
        base, lo, hi = seq_block(cache_k, self.ctx, *live_range(pos, window),
                                 seq_shard)
        if lo <= pos < hi:
            _write_slot(cache_k, k_new, pos - base)
            _write_slot(cache_v, v_new, pos - base)
        nkv = k_new.shape[2]
        qg = q.reshape(b, 1, nkv, q.shape[2] // nkv, hd)
        live = slice(lo - base, hi - base)
        out = lse_combine(*_attend_decode(qg, cache_k[:, live],
                                          cache_v[:, live]),
                          self.ctx.comm if seq_shard else None, "lse")
        return self._out(out.view(b, 1, nkv, -1, hd).to(q.dtype), w[3])


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): compressed latent KV cache + decoupled RoPE
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """On a mesh: ``wq``, ``w_uk``, ``w_uv`` column blocks and ``wo`` row
    blocks of this rank's query heads; ``w_dkv`` and the latent it makes
    are whole on every rank."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__()
        d, h = cfg.d_model, cfg.num_heads
        r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                         cfg.v_head_dim)
        dt = dtype_of(cfg)
        m = ctx.model_size
        self.cfg, self.ctx = cfg, ctx
        self.tp = m > 1 and attn_split(cfg, m) == "heads"
        self.wq = param((d, block(h * (dn + dr), m, "wq")), dt, device,
                        full=(d, h * (dn + dr)))
        self.w_dkv = param((d, r + dr), dt, device)
        self.kv_norm = RMSNorm(r, cfg.norm_eps, device)
        self.w_uk = param((r, block(h * dn, m, "w_uk")), dt, device,
                          full=(r, h * dn))
        self.w_uv = param((r, block(h * dv, m, "w_uv")), dt, device,
                          full=(r, h * dv))
        self.wo = param((block(h * dv, m, "wo"), d), dt, device,
                        full=(h * dv, d))

    def reset_parameters(self, g: torch.Generator) -> None:
        for w in (self.wq, self.w_dkv, self.w_uk, self.w_uv, self.wo):
            normal_(w, full_shape(w)[0] ** -0.5, g)
        self.kv_norm.reset_parameters(g)

    def weights(self):
        """``(wq, w_uk, w_uv, wo)``: this rank's blocks where they hold
        whole heads, else all-gathered over the model axis."""
        w = (self.wq, self.w_uk, self.w_uv, self.wo)
        if self.tp:
            return w
        return tuple(model_gather(t, self.ctx, 0 if i == 3 else 1, "weights")
                     for i, t in enumerate(w))

    def _rope(self, device):
        """The decoupled RoPE part's rotation (YaRN's where the config
        has it) and the softmax scale, ``(dn + dr) ** -0.5`` times YaRN's
        factor."""
        cfg = self.cfg
        rope = rope_for(cfg, cfg.qk_rope_dim, cfg.rope_theta, device)
        return rope, (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5 \
            * rope.softmax

    def _q(self, x, positions, wq, rope):
        cfg = self.cfg
        dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
        q = (x @ wq).reshape(*x.shape[:-1], -1, dn + dr)
        qn, qr = q[..., :dn], q[..., dn:]
        return qn, apply_rope(qr, positions, cfg.rope_theta, rope)

    def _compress(self, x, positions, rope):
        cfg = self.cfg
        r = cfg.kv_lora_rank
        c = x @ self.w_dkv
        ckv = self.kv_norm(c[..., :r])
        krope = apply_rope(c[..., None, r:], positions,
                           cfg.rope_theta, rope)[..., 0, :]
        return ckv, krope

    def _out(self, out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
        return row_parallel(out, wo, self.ctx, "attn") if self.tp \
            else out @ wo

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor):
        """Prefill MLA: expand the latent into per-head K/V and run the
        causal core (``mla_attention``).  Returns ``(out, (ckv, krope))``:
        the cache stores only the (r + dr)-dim latent per token."""
        cfg, ctx = self.cfg, self.ctx
        b, t, _ = x.shape
        dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
        wq, w_uk, w_uv, wo = self.weights()
        rope, scale = self._rope(x.device)
        xq = model_copy(x, ctx, "attn_in") if self.tp else x
        qn, qr = self._q(xq, positions, wq, rope)
        h = qn.shape[2]
        ckv, krope = self._compress(x, positions, rope)
        if self.tp:
            # the whole latent enters this rank's heads
            ckv = model_copy(ckv, ctx, "latent")
            krope = model_copy(krope, ctx, "latent")
        k_nope = (ckv @ w_uk).reshape(b, t, h, dn)
        val = (ckv @ w_uv).reshape(b, t, h, dv)
        out = mla_attention(qn.contiguous(), qr.contiguous(), k_nope,
                            krope.contiguous(), val, scale,
                            q_chunk=cfg.attn_chunk_q,
                            kv_chunk=cfg.attn_chunk_kv)
        out = self._out(out.reshape(b, t, h * dv), wo)
        return out, (ckv, krope)

    def decode(self, x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, pos: int,
               seq_shard: bool = False) -> torch.Tensor:
        """Absorbed-matmul MLA decode: scores and context in the latent
        space, so a step costs O(S * (r + dr)) whatever the head count.

          scores[b,h,s] = (q_nope[b,h] @ W_uk[h]) . ckv[b,s] + q_rope[b,h] . krope[b,s]
          ctx[b,h]      = (sum_s p[b,h,s] ckv[b,s]) @ W_uv[h]

        ``seq_shard``: the latent cache is this data rank's block of the
        sequence; each rank's ``sum_s p ckv`` over its live slots meets the
        others' in ``layers.lse_combine``.
        """
        cfg = self.cfg
        b = x.shape[0]
        r = cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        positions = torch.tensor([pos], dtype=torch.int64, device=x.device)
        wq, w_uk, w_uv, wo = self.weights()
        rope, scale = self._rope(x.device)
        qn, qr = self._q(x, positions, wq, rope)
        h = qn.shape[2]
        ckv_new, krope_new = self._compress(x, positions, rope)
        base, lo, hi = seq_block(cache_ckv, self.ctx, 0, pos + 1, seq_shard)
        if lo <= pos < hi:
            _write_slot(cache_ckv, ckv_new, pos - base)
            _write_slot(cache_krope, krope_new, pos - base)
        f32 = torch.float32
        ckv = cache_ckv[:, lo - base:hi - base].to(f32)
        krope = cache_krope[:, lo - base:hi - base].to(f32)
        w_uk = w_uk.reshape(r, h, dn).to(f32)
        w_uv = w_uv.reshape(r, h, dv).to(f32)
        q_eff = torch.einsum("bqhd,rhd->bhr", qn.to(f32), w_uk)  # absorb W_uk
        scores = (torch.einsum("bhr,bsr->bhs", q_eff, ckv)
                  + torch.einsum("bqhd,bsd->bhs", qr.to(f32), krope))
        m, l, p = _softmax_part(scores * scale)
        ctx_lat = lse_combine(m, l, torch.einsum("bhs,bsr->bhr", p, ckv),
                              self.ctx.comm if seq_shard else None, "lse")
        ctx = torch.einsum("bhr,rhd->bhd", ctx_lat, w_uv)
        return self._out(ctx.reshape(b, 1, h * dv).to(x.dtype), wo)


# ---------------------------------------------------------------------------
# Cross-attention (llama-3.2-vision gated layers / musicgen conditioning)
# ---------------------------------------------------------------------------

class CrossAttention(Attention):
    """Queries from the text stream, K/V from the (stubbed) frontend
    embeddings; no causality, no RoPE; tanh-gated (llama-vision style).
    On a mesh its heads split as self-attention's do."""

    def __init__(self, cfg: ModelConfig, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__(cfg, kv_input_dim=cfg.cond_dim_, device=device,
                         ctx=ctx)
        self.gate = param((), torch.float32, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        super().reset_parameters(g)
        nn.init.zeros_(self.gate)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        w = self.weights()
        q, k, v = self.qkv(x, cond.to(x.dtype), None, 0.0, w)
        nkv = k.shape[2]
        qg = q.reshape(b, t, nkv, q.shape[2] // nkv, cfg.head_dim_)
        qpos = torch.arange(t, device=x.device)
        kpos = torch.arange(cond.shape[1], device=x.device)
        out = _attend_chunked(qg, k, v, qpos, kpos, causal=False, window=0,
                              q_chunk=cfg.attn_chunk_q,
                              kv_chunk=cfg.attn_chunk_kv)
        return torch.tanh(self.gate).to(x.dtype) * self._out(out, w[3])
