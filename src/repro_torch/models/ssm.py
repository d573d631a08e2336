"""Mamba-2 SSD (state-space duality) block, chunked matmul formulation.

The twin of the JAX package's ``models/ssm.py``.  SSD (arXiv:2405.21060)
computes the selective-SSM recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t        y_t = C_t . h_t + D x_t

as chunked matmuls: intra-chunk terms are small [Q, Q] attention-like
products and inter-chunk terms a short scan over per-chunk states, all in
float32 (segment sums and ``exp`` of cumulative decays).  Decode keeps the
O(1) recurrent state [B, H, P, N] plus a (width-1)-deep causal-conv tail.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import RMSNorm, dtype_of, normal_, param


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
        nh, cw = cfg.ssm_heads, cfg.ssm_conv_width
        dconv = di + 2 * n
        dt = dtype_of(cfg)
        self.cfg = cfg
        # z + xBC streams; the per-head dt projection is its own tensor
        self.in_proj = param((d, 2 * di + 2 * n), dt, device)
        self.dt_proj = param((d, nh), dt, device)
        self.conv_w = param((cw, dconv), dt, device)
        self.conv_b = param((dconv,), dt, device)
        self.A_log = param((nh,), torch.float32, device)
        self.D = param((nh,), torch.float32, device)
        self.dt_bias = param((nh,), torch.float32, device)
        self.gate_norm = RMSNorm(di, cfg.norm_eps, device)
        self.out_proj = param((di, d), dt, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        nh = self.cfg.ssm_heads
        with torch.no_grad():
            normal_(self.in_proj, self.in_proj.shape[0] ** -0.5, g)
            normal_(self.dt_proj, self.dt_proj.shape[0] ** -0.5, g)
            normal_(self.conv_w, self.conv_w.shape[0] ** -0.5, g)
            self.conv_b.zero_()
            self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh)))
            self.D.fill_(1.0)
            # softplus(dt_bias) spans [1e-3, 1e-1] (the mamba2 default)
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(nh, generator=g, device=self.dt_bias.device)
            dt_init = torch.exp(u * (hi - lo) + lo)
            self.dt_bias.copy_(dt_init + torch.log(-torch.expm1(-dt_init)))
            self.gate_norm.reset_parameters(g)
            normal_(self.out_proj, self.out_proj.shape[0] ** -0.5, g)

    def _split_in(self, x):
        di = self.cfg.d_inner
        h = x @ self.in_proj
        return h[..., :di], h[..., di:], x @ self.dt_proj

    def _gate_out(self, y, z):
        y = self.gate_norm(y * F.silu(z.to(torch.float32)).to(y.dtype))
        return y @ self.out_proj

    def forward(self, x: torch.Tensor):
        """Full Mamba-2 mixer on a sequence: ``(out [B,T,D], (state,
        conv_tail))``, the second item the decode cache."""
        cfg = self.cfg
        bsz, t, _ = x.shape
        di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        z, xbc, dtr = self._split_in(x)
        xbc, conv_tail = _causal_conv(xbc, self.conv_w, self.conv_b)
        xs = xbc[..., :di].reshape(bsz, t, nh, hp)
        b_mat = xbc[..., di:di + n]
        c_mat = xbc[..., di + n:]
        dt = F.softplus(dtr.to(torch.float32) + self.dt_bias)
        a = -torch.exp(self.A_log)
        y, state = ssd_chunked(xs, dt, a, b_mat, c_mat, cfg.ssm_chunk)
        y = y + self.D[None, None, :, None].to(y.dtype) * xs
        return self._gate_out(y.reshape(bsz, t, di), z), (state, conv_tail)

    def decode(self, x: torch.Tensor, state: torch.Tensor,
               conv_tail: torch.Tensor) -> torch.Tensor:
        """One-token recurrent step.  x: [B, 1, D]; state [B, H, P, N] and
        conv_tail [B, W-1, di+2N] are updated in place."""
        cfg = self.cfg
        bsz = x.shape[0]
        di, n, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        f32 = torch.float32
        z, xbc, dtr = self._split_in(x)
        xbc, new_tail = _causal_conv(xbc, self.conv_w, self.conv_b,
                                     prev_tail=conv_tail)
        xs = xbc[..., :di].reshape(bsz, nh, hp)
        b_mat = xbc[:, 0, di:di + n].to(f32)                  # [B, N]
        c_mat = xbc[:, 0, di + n:].to(f32)
        dt = F.softplus(dtr[:, 0].to(f32) + self.dt_bias)
        a = -torch.exp(self.A_log)
        decay = torch.exp(dt * a[None, :])                    # [B, H]
        upd = torch.einsum("bh,bn,bhp->bhpn", dt, b_mat, xs.to(f32))
        new_state = state * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_mat, new_state)
        y = y + self.D[None, :, None] * xs.to(f32)
        state.copy_(new_state)
        conv_tail.copy_(new_tail)
        return self._gate_out(y.reshape(bsz, 1, di).to(x.dtype), z)


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
    Returns (y [B, T, H, P] in x's dtype, final_state [B, H, P, N] f32).
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
    f32 = torch.float32
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
        l_mat = torch.where(mask[None, :, :, None], torch.exp(seg), 0.0)
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
