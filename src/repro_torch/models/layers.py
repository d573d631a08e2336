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
model axis and split over the data axis by batch.  Every collective
carries its gradient (autograd functions: a sum passes it through, a
copy into the rank's part sums it, a gather keeps the rank's block or
reduce-scatters), and the training loss is vocab-parallel
(``softmax_xent_sharded``), so a mesh's backward gives the single
device's gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

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
    return fill_(t, full)


def fill_(t: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``t`` set from its single-device value ``full``: the whole of it,
    or on a mesh the rank's block of it (``_mesh_fill``)."""
    with torch.no_grad():
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
# Tensor-parallel collectives with gradients (identity on one device)
# ---------------------------------------------------------------------------
#
# The convention of the backward (Megatron's): an activation replicated over
# the model axis has its whole gradient on every model rank.  So a sum of
# the ranks' partial results (``model_sum``) passes its gradient through
# unchanged, and a replicated activation that enters a rank's own slice of
# the work (``model_copy``: its heads, its columns, its tokens) sums the
# ranks' partial gradients.  A gather's backward depends on its consumer
# (``gather_dim``): where every rank computes the same thing with the
# gathered tensor, each rank's gradient is already whole and the backward
# keeps the rank's own block; where the ranks compute different things
# with it, the gradients are partial and the backward is a reduce-scatter.
# Sums in the backward run in float32 and round once to the gradient's
# dtype.  Forward tags count the forward's calls, ``<tag>.grad`` the
# backward's.

F32 = torch.float32


def wide(dt: torch.dtype) -> torch.dtype:
    """The dtype sums and norms run in: float32, or ``dt`` where it is
    wider (float64, the finite-difference tests)."""
    return torch.promote_types(dt, F32)


def _model_comm(ctx: MeshCtx):
    comm = ctx.comm if ctx is not None else None
    return comm if comm is not None and comm.model > 1 else None


def _sum_f32(comm, g: torch.Tensor, axis, tag: str) -> torch.Tensor:
    return comm.all_reduce(g.to(wide(g.dtype)), axis, tag).to(g.dtype)


class _Sum(torch.autograd.Function):
    """All-reduce over ``axis`` forward, identity backward."""

    @staticmethod
    def forward(ctx, x, comm, axis, tag):
        return comm.all_reduce(x, axis, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over ``axis`` backward."""

    @staticmethod
    def forward(ctx, x, comm, axis, tag):
        ctx.comm, ctx.axis, ctx.tag = comm, axis, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(ctx.comm, g, ctx.axis, ctx.tag + ".grad"), None, \
            None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis`` forward; backward: the rank's
    own block (``replicated`` consumer) or a reduce-scatter."""

    @staticmethod
    def forward(ctx, x, comm, axis, dim, tag, replicated):
        ctx.comm, ctx.axis, ctx.dim, ctx.tag = comm, axis, dim, tag
        ctx.replicated, ctx.size = replicated, x.shape[dim]
        return comm.all_gather_dim(x, axis, dim, tag)

    @staticmethod
    def backward(ctx, g):
        comm, dim = ctx.comm, ctx.dim
        if ctx.replicated:
            i = comm.axis_index(ctx.axis)
            out = g.narrow(dim, i * ctx.size, ctx.size).contiguous()
        else:
            out = comm.reduce_scatter(g.movedim(dim, 0).to(F32), ctx.axis,
                                      ctx.tag + ".grad")
            out = out.movedim(0, dim).to(g.dtype)
        return out, None, None, None, None, None


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all`` forward; its backward is the same exchange of
    the gradient (the block permutation is its own inverse)."""

    @staticmethod
    def forward(ctx, x, comm, axis, tag):
        ctx.comm, ctx.axis, ctx.tag = comm, axis, tag
        return comm.all_to_all(x, axis, tag)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g.contiguous(), ctx.axis,
                                   ctx.tag + ".grad"), None, None, None


def mesh_sum(x: torch.Tensor, comm, axis, tag: str) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' ``x`` (a new tensor); the
    gradient passes through unchanged (the sum is replicated)."""
    if comm.axis_size(axis) == 1:
        return x
    return _Sum.apply(x, comm, axis, tag)


def mesh_copy(x: torch.Tensor, comm, axis, tag: str) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``axis``."""
    if comm.axis_size(axis) == 1:
        return x
    return _Copy.apply(x, comm, axis, tag)


def gather_dim(x: torch.Tensor, comm, axis, dim: int, tag: str,
               replicated: bool) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` over ``axis``;
    ``replicated``: every rank computes the same with the result (else
    each its own part)."""
    if comm.axis_size(axis) == 1:
        return x
    return _Gather.apply(x, comm, axis, dim % x.dim(), tag, replicated)


def all_to_all(x: torch.Tensor, comm, axis, tag: str) -> torch.Tensor:
    """``Mesh.all_to_all`` with its backward."""
    if comm.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, comm, axis, tag)


def model_sum(x: torch.Tensor, ctx: MeshCtx, tag: str = "all_reduce",
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum over the model ranks of their partial results, added in
    float32 and rounded once to ``dtype`` (``x``'s by default); its
    gradient passes through."""
    comm = _model_comm(ctx)
    dtype = dtype or x.dtype
    if comm is None:
        return x.to(dtype)
    return mesh_sum(x.to(wide(x.dtype)), comm, "model", tag).to(dtype)


def model_copy(x: torch.Tensor, ctx: MeshCtx,
               tag: str = "copy") -> torch.Tensor:
    """A model-replicated ``x`` entering this rank's slice of the work:
    unchanged forward, the ranks' partial gradients summed backward."""
    comm = _model_comm(ctx)
    return x if comm is None else mesh_copy(x, comm, "model", tag)


class _BmmF32(torch.autograd.Function):
    """The batched product of two bf16/fp16 operands, in float32.

    Forward: on the card the operands stay in their dtype and cuBLAS writes
    float32 (no float32 copy of a cache); the CPU has no such product, so
    they are widened first.  ``torch.bmm(..., out_dtype=...)`` has no
    autograd formula, hence this function.  Backward: the float32
    ``grad_out`` times the other operand widened to float32 (a tile of the
    chunked core or a row-parallel weight block, never a cache), each
    gradient rounded to its operand's
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


def mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in float32: a row-parallel
    rank's partial product, kept unrounded until the ranks' sum (on the
    card a bf16 ``bmm`` with a float32 output; the CPU widens first)."""
    if x.dtype == wide(x.dtype):
        return x @ w
    out = _bmm_f32(x.reshape(1, -1, x.shape[-1]), w[None])
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
                 tag: str = "all_gather",
                 replicated: bool = True) -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim``
    (``gather_dim`` over the model axis)."""
    comm = _model_comm(ctx)
    if comm is None:
        return x
    return gather_dim(x, comm, "model", dim, tag, replicated)


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


def rms_norm_sharded(x: torch.Tensor, scale: torch.Tensor, eps: float,
                     ctx: MeshCtx, d_full: int) -> torch.Tensor:
    """``rms_norm`` over a feature dim split over the model ranks: ``x``
    and ``scale`` are this rank's ``d_full / M`` features.  The float32
    sum of squares is summed over the model ranks and the mean divides by
    ``d_full``.  Each rank normalises its own slice, so the sum's
    consumers differ by rank: its backward all-reduces too (``model_sum``
    then ``model_copy``)."""
    dt = x.dtype
    x = x.to(wide(dt))
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    if _model_comm(ctx) is not None:
        ss = model_copy(model_sum(ss, ctx, "norm"), ctx, "norm")
    x = x * torch.rsqrt(ss / d_full + eps)
    return (x * (1.0 + scale.to(x.dtype))).to(dt)


def lse_combine(m: torch.Tensor, l: torch.Tensor, out: torch.Tensor,
                comm, tag: str = "lse") -> torch.Tensor:
    """The softmax-weighted sum over every data rank's cache slots from
    each rank's part over its own (serving only, no backward): the max
    ``m`` of its scores, the sum ``l`` of ``exp(s - m)`` and its
    softmax-weighted values ``out [..., D]``, all float32.  Without a
    ``comm`` (or with one data rank) that part is the answer.  Else the
    parts are all-gathered over the data axis (one call) and combined in
    rank order on every rank, so every data rank holds the same bits.  A
    rank with no live slot passes ``m = -1e30``, ``l = out = 0``: its
    weight ``l exp(m - max)`` is exactly 0, never NaN."""
    if comm is None or comm.data == 1:
        return out
    part = torch.cat([out, m[..., None], l[..., None]], dim=-1)
    parts = comm.all_gather_dim(part.unsqueeze(0), "data", 0, tag)
    top = parts[..., -2].amax(0)
    num = den = None
    for j in range(comm.data):
        w = parts[j, ..., -1] * torch.exp(parts[j, ..., -2] - top)
        nj = parts[j, ..., :-2] * w[..., None]
        num, den = (nj, w) if num is None else (num + nj, den + w)
    return num / torch.clamp(den, min=1e-30)[..., None]


class RMSNorm(nn.Module):
    """``full``: the single-device width where ``d`` is a mesh rank's
    slice of it (an SSM gate norm split by heads)."""

    def __init__(self, d: int, eps: float, device=None,
                 full: Optional[int] = None):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), torch.float32, device,
                           full=None if full is None else (full,))

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


class Rope(NamedTuple):
    """How a layer rotates: the inverse frequencies ``[D/2]``, the factor
    on cos and sin, and the factor on the softmax scale (both 1 for plain
    RoPE)."""

    inv_freq: torch.Tensor
    cos_sin: float
    softmax: float


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: ``0.1 mscale ln(factor) + 1``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_for(cfg: ModelConfig, dim: int, theta: float, device=None) -> Rope:
    """Plain RoPE, or YaRN where ``cfg.yarn_factor > 1`` (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): the inverse frequencies blend the
    original ones (``extra``) and ones divided by the factor (``inter``)
    by a linear ramp between the correction dimensions of ``beta_fast``
    and ``beta_slow`` rotations over the original context; cos and sin
    take mscale(factor, mscale) / mscale(factor, mscale_all_dim), the
    softmax scale mscale(factor, mscale_all_dim)^2."""
    extra = rope_freqs(dim, theta, device)
    f = cfg.yarn_factor
    if f <= 1:
        return Rope(extra, 1.0, 1.0)

    def corr_dim(rot: float) -> float:
        return dim * math.log(cfg.yarn_original_max_pos
                              / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(corr_dim(cfg.yarn_beta_slow)), dim - 1)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low)
                       / (max(high - low, 0) or 0.001), 0.0, 1.0)
    inv = extra / f * ramp + extra * (1.0 - ramp)
    every = yarn_mscale(f, cfg.yarn_mscale_all_dim)
    return Rope(inv, yarn_mscale(f, cfg.yarn_mscale) / every, every * every)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, rope: Optional[Rope] = None) -> torch.Tensor:
    """x: [..., T, H, D]; positions: broadcastable to [..., T].  ``rope``
    (``rope_for``) replaces plain RoPE of base ``theta``."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device) if rope is None \
        else rope.inv_freq                                   # [D/2]
    angles = positions[..., None].to(torch.float32) * freqs  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]                    # [..., T, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    if rope is not None and rope.cos_sin != 1.0:
        cos, sin = cos * rope.cos_sin, sin * rope.cos_sin
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
    """On a mesh: column-parallel gate/up (the replicated input enters
    this rank's columns: ``model_copy``), row-parallel down, then the
    model all-reduce."""
    x = model_copy(x, mlp.ctx, "mlp_in")
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


class _Rows(torch.autograd.Function):
    """``table[idx]``, whose backward adds each row's gradients in float32
    and rounds once.  (The backward of plain indexing adds in the table's
    dtype, rounding after each repeat of an id: in bf16 the rows of a
    Zipf vocabulary's commonest ids, thousands of repeats a batch, lose
    a tenth of their gradient's norm.)"""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        idx, = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=wide(g.dtype), device=g.device)
        acc.index_add_(0, idx.reshape(-1),
                       g.reshape(-1, ctx.shape[1]).to(acc.dtype))
        return acc.to(ctx.dtype), None


def rows_of(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (rows), with ``_Rows``' backward when it has one."""
    if table.requires_grad and torch.is_grad_enabled():
        return _Rows.apply(table, idx)
    return table[idx]


def embed_lookup(embed: Embedding, tokens: torch.Tensor,
                 layout: VocabLayout) -> torch.Tensor:
    """Token ids -> embeddings via the physical (cyclic) index formula; on
    a mesh the rows another rank holds read as zero here and the model
    all-reduce adds the one rank's row that holds each token (exact in
    any dtype: every other addend is zero)."""
    phys = layout.to_physical(tokens.to(torch.int64))
    if _model_comm(embed.ctx) is None:
        return rows_of(embed.table, phys)
    rows = embed.table.shape[0]
    local = phys - embed.shard * rows
    mine = (local >= 0) & (local < rows)
    out = rows_of(embed.table, local.clamp(0, rows - 1))
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
    return model_sum(out, embed.ctx, "embed")


def lm_head_logits(head: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits *in physical vocab order* [.., pad_rows] (a mesh rank's
    shard of them: [.., pad_rows / M]; ``gather_vocab`` assembles the
    row).  Cross-entropy only needs logsumexp plus the label's logit, so
    they are never permuted back; labels map with the same integer
    formula."""
    return model_copy(x, head.ctx, "head") @ head.table.T


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


def softmax_xent_sharded(logits: torch.Tensor, labels: torch.Tensor,
                         layout: VocabLayout, mask: torch.Tensor,
                         ctx: MeshCtx, shard: int) -> torch.Tensor:
    """``softmax_xent_physical`` on a mesh, vocab-parallel: ``logits`` is
    this rank's shard ``[..., pad_rows / M]`` (physical rows ``shard *
    pad_rows / M`` on, its padding columns excluded here), its rows of the
    batch are its data slice.  The row maxima meet over the model axis
    (an all-gather of one float a row), the sums of exponentials and the
    label's logit (taken on the rank that holds its physical row) in one
    model all-reduce; no rank holds a whole row.  The loss is the global
    masked mean: ``sum(nll * mask)`` summed over the data ranks over the
    all-reduced ``sum(mask)`` (not the mean of the ranks' means)."""
    comm = ctx.comm
    rows = logits.shape[-1]
    lo = shard * rows
    x = logits.to(torch.float32)
    valid = layout.valid_columns(logits.device)
    if valid is not None:
        x = torch.where(valid[lo:lo + rows], x, -math.inf)
    top = x.detach().amax(-1, keepdim=True)
    if comm.model > 1:
        top = comm.all_gather_dim(top, "model", top.dim() - 1,
                                  "xent_max").amax(-1, keepdim=True)
    lab = layout.to_physical(labels.to(torch.int64)) - lo
    mine = (lab >= 0) & (lab < rows)
    picked = torch.gather(x, -1, lab.clamp(0, rows - 1)[..., None])[..., 0]
    parts = torch.stack([torch.exp(x - top).sum(-1),
                         torch.where(mine, picked, 0.0)])
    parts = mesh_sum(parts, comm, "model", "xent")
    nll = torch.log(parts[0]) + top[..., 0] - parts[1]
    num = mesh_sum(torch.sum(nll * mask).reshape(1), comm, "data",
                   "xent_sum")
    den = torch.sum(mask).reshape(1).to(torch.float32)
    if comm.data > 1:
        den = comm.all_reduce(den, "data", "xent_sum")
    return (num / torch.clamp(den, min=1.0))[0]
