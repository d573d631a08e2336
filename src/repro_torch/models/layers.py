"""Shared neural layers: norms, RoPE, MLPs, and the cyclic-sharded embedding.

The twin of the JAX package's ``models/layers.py``.  The embedding table is
stored in the parameter server's cyclic physical order (paper section 2.2):
token frequency is Zipfian like word frequency, so the hottest rows spread
over the shards.  Lookups and the LM head work in physical order (the
logical->physical map is an integer formula), so the layout costs nothing
at run time.

Weights keep the JAX package's ``[d_in, d_out]`` layout (``x @ w``), so
parameters carry across from it unchanged (``convert.lm_params_from_arrays``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import torch_dtype
from repro_torch.core.pserver import CyclicLayout


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with N(0, std^2) drawn in float32, then cast (the JAX
    package draws in float32 and casts to the parameter dtype)."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=g, device=t.device,
                            dtype=torch.float32) * std)
    return t


def param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32 with the ``1 + scale`` parametrisation."""
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), torch.float32, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.zeros_(self.scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                   # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def activation(h: torch.Tensor, act: str) -> torch.Tensor:
    """``jax.nn.silu`` or ``jax.nn.gelu``, whose default is the tanh
    approximation (torch's default is the exact erf form)."""
    if act == "silu":
        return F.silu(h)
    return F.gelu(h, approximate="tanh")


def apply_mlp(mlp: "MLP", x: torch.Tensor, act: str) -> torch.Tensor:
    h = activation(x @ mlp.w_gate, act) * (x @ mlp.w_up)
    return h @ mlp.w_down


class MLP(nn.Module):
    def __init__(self, d: int, f: int, dtype, device=None):
        super().__init__()
        self.w_gate = param((d, f), dtype, device)
        self.w_up = param((d, f), dtype, device)
        self.w_down = param((f, d), dtype, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        d, f = self.w_gate.shape
        normal_(self.w_gate, d ** -0.5, g)
        normal_(self.w_up, d ** -0.5, g)
        normal_(self.w_down, f ** -0.5, g)

    def forward(self, x: torch.Tensor, act: str) -> torch.Tensor:
        return apply_mlp(self, x, act)


# ---------------------------------------------------------------------------
# Cyclic vocab-sharded embedding (the paper's layout as an LM feature)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VocabLayout:
    """Wraps CyclicLayout for the embedding table; ``blocked`` is the naive
    contiguous layout the paper's figure 5 compares against."""

    vocab_size: int
    num_shards: int
    mode: str  # "cyclic" | "blocked"

    @property
    def cyclic(self) -> CyclicLayout:
        return CyclicLayout(self.vocab_size, self.num_shards)

    @property
    def pad_rows(self) -> int:
        return self.cyclic.pad_rows

    def to_physical(self, token):
        if self.mode == "blocked":
            return token
        return self.cyclic.to_physical(token)

    def valid_columns(self, device=None) -> Optional[torch.Tensor]:
        """Bool [pad_rows]: which physical rows hold a real token (None when
        every row does)."""
        if self.pad_rows == self.vocab_size:
            return None
        phys = torch.arange(self.pad_rows, dtype=torch.int64, device=device)
        return self.cyclic.to_logical(phys) < self.vocab_size


class Embedding(nn.Module):
    """The ``[pad_rows, d_model]`` table in physical (cyclic) row order."""

    def __init__(self, layout: VocabLayout, d: int, dtype, device=None):
        super().__init__()
        self.layout = layout
        self.table = param((layout.pad_rows, d), dtype, device)

    def reset_parameters(self, g: torch.Generator) -> None:
        normal_(self.table, self.table.shape[1] ** -0.5, g)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self, tokens, self.layout)


def embed_lookup(embed: Embedding, tokens: torch.Tensor,
                 layout: VocabLayout) -> torch.Tensor:
    """Token ids -> embeddings via the physical (cyclic) index formula."""
    phys = layout.to_physical(tokens.to(torch.int64))
    return embed.table[phys]


def lm_head_logits(head: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits *in physical vocab order* [.., pad_rows].  Cross-entropy only
    needs logsumexp plus the label's logit, so they are never permuted
    back; labels map with the same integer formula."""
    return x @ head.table.T


def softmax_xent_physical(logits_phys: torch.Tensor, labels: torch.Tensor,
                          layout: VocabLayout,
                          mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over physically-ordered logits; the padding rows of the
    cyclic table (logical id >= vocab_size) are excluded from the
    logsumexp."""
    valid = layout.valid_columns(logits_phys.device)
    if valid is not None:
        logits_phys = torch.where(valid, logits_phys, -math.inf)
    logits_phys = logits_phys.to(torch.float32)
    lse = torch.logsumexp(logits_phys, dim=-1)
    lab_phys = layout.to_physical(labels.to(torch.int64))
    lab_logit = torch.gather(logits_phys, -1, lab_phys[..., None])[..., 0]
    nll = lse - lab_logit
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
