"""Mamba-2 SSD (state-space duality) block, chunked matmul formulation.

The twin of the JAX package's ``models/ssm.py``.  SSD (arXiv:2405.21060)
computes the selective-SSM recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t        y_t = C_t . h_t + D x_t

as chunked matmuls: intra-chunk terms are small [Q, Q] attention-like
products and inter-chunk terms a short scan over per-chunk states, all in
float32 (segment sums and ``exp`` of cumulative decays).  Decode keeps the
O(1) recurrent state [B, H, P, N] plus a (width-1)-deep causal-conv tail.

**On a mesh** the split follows from ``cfg`` and the model axis alone
(``sharding.specs.ssm_split``):

  * ``"heads"`` -- the SSD heads tile the model axis: rank ``i`` runs its
    ``H/M`` heads.  It holds ``in_proj``'s columns regrouped as ``[z of its
    heads | x of its heads | B | C]``, ``conv_w``/``conv_b``'s channels as
    ``[x of its heads | B | C]`` (``to_rank_columns``: the rules cut
    ``in_proj`` into contiguous blocks, which cross the z/x/B/C
    boundaries; the port's block costs ``2N (1 - 1/M)`` more columns and
    conv channels a rank), ``dt_proj``'s columns, ``A_log``, ``D`` and
    ``dt_bias`` of its heads, its slice of the gate norm's scale
    (``specs.port_spec``) and its rows of the row-parallel ``out_proj``.
    ``B`` and ``C`` are shared by every head (ngroups = 1), so every rank
    computes them: their weight columns and conv channels enter through
    ``layers.model_copy`` (each rank's gradient of them covers its own
    heads), as does the replicated input.  The gated norm runs over all
    of ``d_inner`` (``layers.rms_norm_sharded``).  The decode cache is the
    heads' state ``[B, H/M, P, N]`` and the conv tail ``[B, W-1, d_inner/M
    + 2N]``.
  * ``"gather"`` -- they do not: the rules' contiguous blocks, all-gathered
    per use, the whole mixer on every rank (its gradient: the rank's
    block), the cache whole -- what ``Attention`` does in ``"gather"``
    mode.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (RMSNorm, block, dtype_of, fill_,
                                       full_shape, model_copy, model_gather,
                                       normal_, param, rms_norm_sharded,
                                       row_parallel, wide)
from repro_torch.sharding.specs import SINGLE, MeshCtx, ssm_split

# the leaves whose columns a "heads" rank holds regrouped, and how many
# streams of d_inner come before the shared B | C columns in each
REGROUPED = {"in_proj": 2, "conv_w": 1, "conv_b": 1}


def regrouped(name: str, cfg: ModelConfig, m: int) -> bool:
    """Whether parameter ``name``'s blocks on a model axis of ``m`` are the
    port's regrouped columns (``to_rank_columns``)."""
    parts = name.split(".")
    return (m > 1 and len(parts) > 1 and parts[-2] == "ssm"
            and parts[-1] in REGROUPED and ssm_split(cfg, m) == "heads")


def to_rank_columns(name: str, t: torch.Tensor, cfg: ModelConfig,
                    m: int) -> torch.Tensor:
    """A regrouped leaf's single-device value ``t`` (last dim ``[z | x | B |
    C]`` or ``[x | B | C]``) as the concatenation of the ``m`` ranks'
    blocks along the last dim: block ``i`` is ``[z_i | x_i | B | C]``
    (``[x_i | B | C]``), ``z_i``/``x_i`` rank ``i``'s heads' columns."""
    di, streams = cfg.d_inner, REGROUPED[name.split(".")[-1]]
    dl = di // m
    cols = []
    for i in range(m):
        cols += [torch.arange(s * di + i * dl, s * di + (i + 1) * dl)
                 for s in range(streams)]
        cols.append(torch.arange(streams * di, t.shape[-1]))
    # one gather by column index (a ``cat`` of the slices would do the
    # same, but on the meta probes of ``transformer._attach_fill`` it
    # imports the compiler stack, seconds a rank process)
    return t[..., torch.cat(cols).to(t.device)]


def from_rank_columns(name: str, t: torch.Tensor, cfg: ModelConfig,
                      m: int) -> torch.Tensor:
    """The inverse of ``to_rank_columns`` (``B``/``C`` from rank 0's
    block: every rank holds the same)."""
    streams = REGROUPED[name.split(".")[-1]]
    dl = cfg.d_inner // m
    w = t.shape[-1] // m
    blocks = [t[..., i * w:(i + 1) * w] for i in range(m)]
    out = [torch.cat([b[..., s * dl:(s + 1) * dl] for b in blocks], dim=-1)
           for s in range(streams)]
    return torch.cat(out + [blocks[0][..., streams * dl:]], dim=-1)


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, cw = cfg.ssm_heads, cfg.ssm_conv_width
        dt = dtype_of(cfg)
        m = ctx.model_size
        self.cfg, self.ctx = cfg, ctx
        # "heads": this rank's heads; "gather": the whole mixer per use
        self.tp = m > 1 and ssm_split(cfg, m) == "heads"
        self.gather = m > 1 and not self.tp
        hm = m if self.tp else 1
        # this rank's heads and d_inner columns
        self.heads, self.d_in = nh // hm, di // hm
        dl, hl = self.d_in, self.heads
        gm = m if self.gather else 1

        def cols(local, full):        # a "gather" rank's contiguous block
            return local if gm == 1 else block(full, gm, "ssm columns")

        # z + xBC streams; the per-head dt projection is its own tensor
        self.in_proj = param((d, cols(2 * dl + 2 * n, 2 * di + 2 * n)), dt,
                             device, full=(d, 2 * di + 2 * n))
        self.dt_proj = param((d, hl), dt, device, full=(d, nh))
        self.conv_w = param((cw, cols(dl + 2 * n, di + 2 * n)), dt, device,
                            full=(cw, di + 2 * n))
        self.conv_b = param((cols(dl + 2 * n, di + 2 * n),), dt, device,
                            full=(di + 2 * n,))
        self.A_log = param((hl,), torch.float32, device, full=(nh,))
        self.D = param((hl,), torch.float32, device, full=(nh,))
        self.dt_bias = param((hl,), torch.float32, device, full=(nh,))
        self.gate_norm = RMSNorm(dl, cfg.norm_eps, device, full=di)
        self.out_proj = param((cols(dl, di), d), dt, device, full=(di, d))
        if self.tp:
            # every model rank holds the same trailing B | C columns
            for w in (self.in_proj, self.conv_w, self.conv_b):
                w._model_shared = 2 * n

    def reset_parameters(self, g: torch.Generator) -> None:
        nh = self.cfg.ssm_heads
        with torch.no_grad():
            normal_(self.in_proj, full_shape(self.in_proj)[0] ** -0.5, g)
            normal_(self.dt_proj, full_shape(self.dt_proj)[0] ** -0.5, g)
            normal_(self.conv_w, full_shape(self.conv_w)[0] ** -0.5, g)
            self.conv_b.zero_()
            fill_(self.A_log, torch.log(torch.linspace(1.0, 16.0, nh)))
            fill_(self.D, torch.ones(nh))
            # softplus(dt_bias) spans [1e-3, 1e-1] (the mamba2 default)
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(nh, generator=g, device=self.dt_bias.device)
            dt_init = torch.exp(u * (hi - lo) + lo)
            fill_(self.dt_bias, dt_init + torch.log(-torch.expm1(-dt_init)))
            self.gate_norm.reset_parameters(g)
            normal_(self.out_proj, full_shape(self.out_proj)[0] ** -0.5, g)

    def weights(self):
        """``(in_proj, conv_w, conv_b, out_proj)`` as this rank computes
        with them: its blocks, the shared B | C columns entering through
        ``model_copy`` in ``"heads"`` mode; all-gathered over the model
        axis in ``"gather"`` mode (every rank computes the same)."""
        w = (self.in_proj, self.conv_w, self.conv_b, self.out_proj)
        ctx = self.ctx
        if self.gather:
            return tuple(model_gather(t, ctx, 0 if i >= 2 else 1,
                                      "ssm_weights")
                         for i, t in enumerate(w))
        if not self.tp:
            return w
        dl = self.d_in

        def shared(t, at):
            return torch.cat([t[..., :at],
                              model_copy(t[..., at:], ctx, "ssm_bc")], -1)

        return (shared(w[0], 2 * dl), shared(w[1], dl), shared(w[2], dl),
                w[3])

    def _split_in(self, x, w_in):
        dl = self.d_in
        h = x @ w_in
        return h[..., :dl], h[..., dl:], x @ self.dt_proj

    def _gate_out(self, y, z, w_out):
        y = y * F.silu(z.to(wide(z.dtype))).to(y.dtype)
        if self.tp:
            y = rms_norm_sharded(y, self.gate_norm.scale, self.gate_norm.eps,
                                 self.ctx, self.cfg.d_inner)
            return row_parallel(y, w_out, self.ctx, "ssm")
        return self.gate_norm(y) @ w_out

    def forward(self, x: torch.Tensor):
        """Full Mamba-2 mixer on a sequence: ``(out [B,T,D], (state,
        conv_tail))``, the second item the decode cache (this rank's
        heads')."""
        cfg = self.cfg
        bsz, t, _ = x.shape
        dl, n, hl, hp = self.d_in, cfg.ssm_state, self.heads, \
            cfg.ssm_head_dim
        w_in, conv_w, conv_b, w_out = self.weights()
        if self.tp:
            x = model_copy(x, self.ctx, "ssm_in")
        z, xbc, dtr = self._split_in(x, w_in)
        xbc, conv_tail = _causal_conv(xbc, conv_w, conv_b)
        xs = xbc[..., :dl].reshape(bsz, t, hl, hp)
        b_mat = xbc[..., dl:dl + n]
        c_mat = xbc[..., dl + n:]
        dt = F.softplus(dtr.to(wide(dtr.dtype)) + self.dt_bias)
        a = -torch.exp(self.A_log)
        y, state = ssd_chunked(xs, dt, a, b_mat, c_mat, cfg.ssm_chunk)
        y = y + self.D[None, None, :, None].to(y.dtype) * xs
        return self._gate_out(y.reshape(bsz, t, dl), z, w_out), \
            (state, conv_tail)

    def decode(self, x: torch.Tensor, state: torch.Tensor,
               conv_tail: torch.Tensor) -> torch.Tensor:
        """One-token recurrent step.  x: [B, 1, D]; state [B, H, P, N] and
        conv_tail [B, W-1, di+2N] (this rank's heads and channels) are
        updated in place."""
        cfg = self.cfg
        bsz = x.shape[0]
        dl, n, hl, hp = self.d_in, cfg.ssm_state, self.heads, \
            cfg.ssm_head_dim
        f32 = torch.float32
        w_in, conv_w, conv_b, w_out = self.weights()
        z, xbc, dtr = self._split_in(x, w_in)
        xbc, new_tail = _causal_conv(xbc, conv_w, conv_b,
                                     prev_tail=conv_tail)
        xs = xbc[..., :dl].reshape(bsz, hl, hp)
        b_mat = xbc[:, 0, dl:dl + n].to(f32)                  # [B, N]
        c_mat = xbc[:, 0, dl + n:].to(f32)
        dt = F.softplus(dtr[:, 0].to(f32) + self.dt_bias)
        a = -torch.exp(self.A_log)
        decay = torch.exp(dt * a[None, :])                    # [B, H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dt, b_mat, xs.to(f32))
        new_state = state * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_mat, new_state)
        y = y + self.D[None, :, None] * xs.to(f32)
        state.copy_(new_state)
        conv_tail.copy_(new_tail)
        return self._gate_out(y.reshape(bsz, 1, dl).to(x.dtype), z, w_out)


def _causal_conv(xbc, conv_w, conv_b, prev_tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width W.  ``prev_tail``: [B, W-1, C] history
    for decode (None -> zero history, i.e. sequence start).  Returns
    ``(silu(conv + b), new tail)``."""
    w = conv_w.shape[0]
    if prev_tail is None:
        prev_tail = torch.zeros((xbc.shape[0], w - 1, xbc.shape[-1]),
                                dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([prev_tail.to(xbc.dtype), xbc], dim=1)
    t = xbc.shape[1]
    out = xp[:, 0:t] * conv_w[0]
    for i in range(1, w):
        out = out + xp[:, i:i + t] * conv_w[i]
    return F.silu(out + conv_b), xp[:, -(w - 1):]


def ssd_chunked(x, dt, a, b_mat, c_mat, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:     [B, T, H, P]   (already conv'd + activated inner stream)
    dt:    [B, T, H]      (softplus'd step sizes)
    a:     [H]            (negative reals, -exp(A_log))
    b_mat: [B, T, N]      c_mat: [B, T, N]   (ngroups == 1, shared over heads)
    Returns (y [B, T, H, P] in x's dtype, final_state [B, H, P, N] f32;
    float64 inputs run in float64).
    """
    bsz, t, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        # dt = 0 at padded positions: decay exp(0)=1 and zero input, so the
        # recurrence (and final state) is unchanged by padding
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, pad))
    nc = (t + pad) // q
    f32 = wide(x.dtype)
    xc = x.reshape(bsz, nc, q, h, p).to(f32)
    dtc = dt.reshape(bsz, nc, q, h).to(f32)
    bc = b_mat.reshape(bsz, nc, q, n).to(f32)
    cc = c_mat.reshape(bsz, nc, q, n).to(f32)

    da = dtc * a[None, None, None, :]               # [B,Nc,Q,H]
    cum = torch.cumsum(da, dim=2)                   # within-chunk cumsum
    xdt = xc * dtc[..., None]                       # [B,Nc,Q,H,P]

    # intra-chunk (diagonal blocks) + per-chunk input states, one chunk's
    # [Q, Q, H] decay tile at a time (the reference maps over chunks)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    y_diag, states = [], []
    for ci in range(nc):
        cum_c, xdt_c, bc_c, cc_c = cum[:, ci], xdt[:, ci], bc[:, ci], cc[:, ci]
        seg = cum_c[:, :, None, :] - cum_c[:, None, :, :]      # [B,Q,Q,H]
        # the upper triangle's seg is positive and exp can overflow: mask
        # it before exp, so its gradient is 0 and not 0 * inf = NaN (the
        # reference masks after exp)
        l_mat = torch.exp(torch.where(mask[None, :, :, None], seg,
                                      -math.inf))
        cb = torch.einsum("bin,bjn->bij", cc_c, bc_c)          # [B,Q,Q]
        y_diag.append(torch.einsum("bijh,bjhp->bihp",
                                   cb[..., None] * l_mat, xdt_c))
        decay_in = torch.exp(cum_c[:, -1:, :] - cum_c)         # [B,Q,H]
        states.append(torch.einsum("bjn,bjhp->bhpn", bc_c,
                                   decay_in[..., None] * xdt_c))

    # inter-chunk recurrence (short scan over Nc chunks)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [B,Nc,H]
    prev = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
            if init_state is None else init_state.to(f32))
    entering = []
    for ci in range(nc):
        entering.append(prev)
        prev = states[ci] + chunk_decay[:, ci, :, None, None] * prev
    entering = torch.stack(entering, dim=1)                    # [B,Nc,H,P,N]

    # contribution of the entering state to each position
    decay_out = torch.exp(cum)                                 # [B,Nc,Q,H]
    y_off = torch.einsum("bcin,bchpn->bcihp", cc, entering) \
        * decay_out[..., None]
    y = (torch.stack(y_diag, dim=1) + y_off).reshape(bsz, nc * q, h, p)[:, :t]
    return y.to(x.dtype), prev
