"""Shared neural layers: norms, RoPE, MLPs, and the cyclic-sharded embedding.

The twin of the JAX package's ``models/layers.py``.  The embedding table is
stored in the parameter server's cyclic physical order (paper section 2.2):
token frequency is Zipfian like word frequency, so the hottest rows spread
over the shards.  Lookups and the LM head work in physical order (the
logical->physical map is an integer formula), so the layout costs nothing
at run time.

Weights keep the JAX package's ``[d_in, d_out]`` layout (``x @ w``), so
parameters carry across from it unchanged (``convert.lm_params_from_arrays``).

**On a mesh** (a ``MeshCtx`` whose mesh is a rank's ``launch.mesh.Mesh``)
each module holds this rank's block of every weight, as the rules of
``sharding.specs`` place it, and issues the collectives the reference's
GSPMD inserts: the vocab-parallel ``Embedding`` (rank ``m`` holds the
logical rows ``v = m (mod M)``, its contiguous physical shard; a lookup is
a masked local gather and a model all-reduce), the per-shard LM head
(``gather_vocab`` assembles the physical row), and the MLP as
column-parallel ``w_gate``/``w_up`` and row-parallel ``w_down`` followed
by a model all-reduce.  A row-parallel product keeps each rank's partial
in float32, the ranks' sum is added in float32 and rounded once to the
activation dtype (``row_parallel``), so it is the single device's product
up to float32 order; the hidden between layers is replicated over the
model axis and split over the data axis by batch.
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
from repro_torch.sharding.specs import SINGLE, MeshCtx


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def normal_(t: torch.Tensor, std: float, g: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with N(0, std^2) drawn in float32, then cast (the JAX
    package draws in float32 and casts to the parameter dtype).  A mesh
    rank's block draws the whole single-device leaf (``full_shape``) and
    keeps its block (``_mesh_fill``), so every rank holds slices of the
    same logical weights the single-device model draws from the seed."""
    with torch.no_grad():
        full = torch.randn(full_shape(t), generator=g, device=t.device,
                           dtype=torch.float32)
        full.mul_(std)
        fill = getattr(t, "_mesh_fill", None)
        t.copy_(full if fill is None else fill(full))
    return t


def param(shape, dtype, device, full=None) -> nn.Parameter:
    """An uninitialised parameter of ``shape``; ``full`` is the
    single-device leaf's shape where ``shape`` is a mesh rank's block."""
    p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    p._full_shape = tuple(full if full is not None else shape)
    return p


def full_shape(t: torch.Tensor) -> tuple:
    """The single-device shape of a parameter (its own on one device)."""
    return tuple(getattr(t, "_full_shape", t.shape))


def block(n: int, m: int, what: str) -> int:
    """``n // m``, raising where ``m`` model ranks do not split ``n``."""
    if n % m:
        raise ValueError(f"{what}: {n} does not split over {m} model ranks")
    return n // m


# ---------------------------------------------------------------------------
# Tensor-parallel collectives (identity on one device)
# ---------------------------------------------------------------------------

def _model_comm(ctx: MeshCtx):
    comm = ctx.comm if ctx is not None else None
    return comm if comm is not None and comm.model > 1 else None


def model_sum(x: torch.Tensor, ctx: MeshCtx, tag: str = "all_reduce",
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum over the model ranks of their partial results, added in
    float32 and rounded once to ``dtype`` (``x``'s by default)."""
    comm = _model_comm(ctx)
    dtype = dtype or x.dtype
    if comm is None:
        return x.to(dtype)
    return comm.all_reduce(x.to(torch.float32), "model", tag).to(dtype)


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32: a row-parallel
    rank's partial product, kept unrounded until the ranks' sum (on the
    card a bf16 ``bmm`` with a float32 output; the CPU widens first)."""
    if x.dtype == torch.float32:
        return x @ w
    x3 = x.reshape(1, -1, x.shape[-1])
    if x.is_cuda:
        out = torch.bmm(x3, w[None], out_dtype=torch.float32)
    else:
        out = torch.bmm(x3.to(torch.float32), w.to(torch.float32)[None])
    return out.reshape(*x.shape[:-1], w.shape[-1])


def row_parallel(h: torch.Tensor, w: torch.Tensor, ctx: MeshCtx,
                 tag: str) -> torch.Tensor:
    """``h @ w`` of a row-parallel weight: on one device the plain
    product; on a model axis each rank's float32 partial product, summed
    over the ranks in float32 and rounded once, so the result is the
    single device's product up to float32 order."""
    if _model_comm(ctx) is None:
        return h @ w
    return model_sum(mm_f32(h, w), ctx, tag, dtype=h.dtype)


def model_gather(x: torch.Tensor, ctx: MeshCtx, dim: int,
                 tag: str = "all_gather") -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim``."""
    comm = _model_comm(ctx)
    if comm is None:
        return x
    return comm.all_gather_dim(x, "model", dim % x.dim(), tag)


def gather_vocab(logits: torch.Tensor, ctx: MeshCtx) -> torch.Tensor:
    """A shard's logits ``[..., pad_rows / M]`` -> the physical row
    ``[..., pad_rows]`` (an all-gather over the model group)."""
    return model_gather(logits, ctx, -1, tag="logits")


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
    """On a mesh: column-parallel gate/up, row-parallel down, then the
    model all-reduce."""
    h = activation(x @ mlp.w_gate, act) * (x @ mlp.w_up)
    return row_parallel(h, mlp.w_down, mlp.ctx, "mlp")


class MLP(nn.Module):
    def __init__(self, d: int, f: int, dtype, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__()
        fl = block(f, ctx.model_size, "mlp d_ff")
        self.ctx = ctx
        self.w_gate = param((d, fl), dtype, device, full=(d, f))
        self.w_up = param((d, fl), dtype, device, full=(d, f))
        self.w_down = param((fl, d), dtype, device, full=(f, d))

    def reset_parameters(self, g: torch.Generator) -> None:
        d, f = full_shape(self.w_gate)
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
    """The ``[pad_rows, d_model]`` table in physical (cyclic) row order;
    on a mesh of ``M`` model ranks, rank ``shard`` holds physical rows
    ``[shard * pad_rows / M, (shard + 1) * pad_rows / M)``: the logical
    rows ``v = shard (mod M)`` of the cyclic layout.  Its single-device
    leaf is the ``[vocab, d_model]`` table of the one-shard layout."""

    def __init__(self, layout: VocabLayout, d: int, dtype, device=None, *,
                 ctx: MeshCtx = SINGLE, shard: int = 0):
        super().__init__()
        self.layout, self.ctx, self.shard = layout, ctx, int(shard)
        rows = block(layout.pad_rows, ctx.model_size, "vocab rows")
        single = VocabLayout(layout.vocab_size, 1, layout.mode).pad_rows
        self.table = param((rows, d), dtype, device, full=(single, d))

    def reset_parameters(self, g: torch.Generator) -> None:
        normal_(self.table, self.table.shape[1] ** -0.5, g)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_lookup(self, tokens, self.layout)


def embed_lookup(embed: Embedding, tokens: torch.Tensor,
                 layout: VocabLayout) -> torch.Tensor:
    """Token ids -> embeddings via the physical (cyclic) index formula; on
    a mesh the rows another rank holds read as zero here and the model
    all-reduce adds the one rank's row that holds each token (exact in
    any dtype: every other addend is zero)."""
    phys = layout.to_physical(tokens.to(torch.int64))
    if _model_comm(embed.ctx) is None:
        return embed.table[phys]
    rows = embed.table.shape[0]
    local = phys - embed.shard * rows
    mine = (local >= 0) & (local < rows)
    out = embed.table[local.clamp(0, rows - 1)]
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
    return model_sum(out, embed.ctx, "embed")


def lm_head_logits(head: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits *in physical vocab order* [.., pad_rows] (a mesh rank's
    shard of them: [.., pad_rows / M]; ``gather_vocab`` assembles the
    row).  Cross-entropy only needs logsumexp plus the label's logit, so
    they are never permuted back; labels map with the same integer
    formula."""
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
