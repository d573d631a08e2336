"""Mixture-of-Experts, the dense single-device path.

The twin of the JAX package's ``models/moe.py`` on one device: top-k
routing (``_route``) and the exact dense block (``moe_block_dense``: every
expert on every token, gate-masked, no capacity drops), which is what the
JAX package's ``moe_block`` runs without a mesh.  The expert-parallel
shard_map path (``moe_block_spmd``, ``_moe_local``, ``_group_by``: experts
on model shards cyclically, tokens pushed to their owners through
fixed-capacity all-to-all buffers) is ROADMAP A.8.3.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import MLP, dtype_of, normal_, param


class Experts(nn.Module):
    """Per-expert SwiGLU weights, stacked over the expert axis."""

    def __init__(self, e: int, d: int, fe: int, dtype, device=None):
        super().__init__()
        self.w_gate = param((e, d, fe), dtype, device)
        self.w_up = param((e, d, fe), dtype, device)
        self.w_down = param((e, fe, d), dtype, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        _, d, fe = self.w_gate.shape
        normal_(self.w_gate, d ** -0.5, g)
        normal_(self.w_up, d ** -0.5, g)
        normal_(self.w_down, fe ** -0.5, g)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        fe = cfg.moe_d_ff or cfg.d_ff
        dt = dtype_of(cfg)
        self.cfg = cfg
        self.router = param((d, e), torch.float32, device)
        self.experts = Experts(e, d, fe, dt, device)
        if cfg.num_shared_experts > 0:
            self.shared = MLP(d, fe * cfg.num_shared_experts, dt, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        normal_(self.router, self.router.shape[0] ** -0.5, g)
        self.experts.reset_parameters(g)
        if self.cfg.num_shared_experts > 0:
            self.shared.reset_parameters(g)

    def forward(self, x: torch.Tensor):
        return moe_block(self, x, self.cfg)


def _route(moe: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing.  x: [T, D] -> (gates [T,k], experts [T,k], aux-loss)."""
    logits = x.to(torch.float32) @ moe.router
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = cfg.num_experts
    flat = ids.reshape(-1)
    frac = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / (x.shape[0] * cfg.top_k),
                            dtype=torch.float32, device=x.device))
    aux = e * torch.sum(frac * probs.mean(0))
    return gates, ids, aux


def moe_block_dense(moe: MoE, x: torch.Tensor, cfg: ModelConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, D].  Exact MoE (no capacity drops); O(E) compute."""
    gates, ids, aux = _route(moe, x, cfg)
    t = x.shape[0]
    # [T, E] combined gate per expert
    gate_e = torch.zeros((t, cfg.num_experts), dtype=x.dtype,
                         device=x.device).scatter_add_(1, ids,
                                                       gates.to(x.dtype))
    we = moe.experts
    h = torch.einsum("td,edf->tef", x, we.w_gate)
    u = torch.einsum("td,edf->tef", x, we.w_up)
    y = torch.einsum("tef,efd->ted", F.silu(h) * u, we.w_down)
    out = torch.einsum("ted,te->td", y, gate_e)
    if cfg.num_shared_experts > 0:
        out = out + moe.shared(x, cfg.act)
    return out, aux


def moe_block(moe: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, D] in/out.  On one device (the JAX package's ``SINGLE``, the
    only context the port has) this is the dense path."""
    b, s, d = x.shape
    y, aux = moe_block_dense(moe, x.reshape(b * s, d), cfg)
    return y.reshape(b, s, d), aux
