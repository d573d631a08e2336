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
scanned layer and each cross-attention layer does.  On a mesh the rerun
issues the layer's collectives again; every rank's graph is the same, so
every rank reruns at the same point, and the MoE layers count their
drops in the first run only.

On a mesh (a ``MeshCtx`` over a rank's ``launch.mesh.Mesh``) the model
holds this rank's block of every parameter (``sharding.specs`` rules, the
vocab tables and expert stacks in the mesh's cyclic order, an SSM mixer
split by heads in its regrouped columns: ``specs.port_spec``,
``models/ssm.py``), its batch slice of the hidden, and its cache
(``allocate_cache(..., ctx)``); the logits it returns are its vocab shard
(``layers.gather_vocab`` makes the row).  A batch smaller than the data
axis is served with a sequence-sharded cache (``Caches.seq_shard``):
every data rank holds the whole batch and its block of each attention
cache's slots (prefill writes the positions of its block, decode's slot
is written by its owner).
``init_params`` draws each leaf whole in the single-device order and
keeps the rank's block, so a mesh of any shape holds the same logical
weights as the single-device model of that seed.

Entry points:
  forward(...)       logits over full sequences (optionally filling a cache)
  loss_fn(...)       the training loss (cross-entropy + router aux)
  prefill(...)       last-position logits + a populated cache
  decode_step(...)   one token with the cache (the serve path)
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.device import Device, resolve_device
from repro_torch.core.pserver import CyclicLayout
from repro_torch.models.attention import (MLA, Attention, CrossAttention,
                                          cache_kv_heads)
from repro_torch.models.layers import (MLP, Embedding, RMSNorm, VocabLayout,
                                       dtype_of, lm_head_logits, param,
                                       softmax_xent_physical,
                                       softmax_xent_sharded)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM
from repro_torch.obs import marks
from repro_torch.sharding import specs
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

    def __init__(self, cfg: ModelConfig, kind: str, device=None, *,
                 ctx: MeshCtx = SINGLE):
        super().__init__()
        d, eps, dt = cfg.d_model, cfg.norm_eps, dtype_of(cfg)
        self.cfg, self.kind = cfg, kind
        self.ln1 = RMSNorm(d, eps, device)
        if kind == "cross":
            self.attn_x = CrossAttention(cfg, device, ctx=ctx)
            self.ln2 = RMSNorm(d, eps, device)
            self.mlp = MLP(d, cfg.d_ff, dt, device, ctx=ctx)
            self.mlp_gate = param((), torch.float32, device)
            return
        self.ssm_only = cfg.ssm_state > 0 and not cfg.hybrid
        if self.ssm_only and not cfg.has_attention:
            self.ssm = SSM(cfg, device, ctx=ctx)
            return                  # mamba2 block: norm + mixer only
        if cfg.has_attention:
            self.attn = (MLA(cfg, device, ctx=ctx) if cfg.use_mla
                         else Attention(cfg, device=device, ctx=ctx))
        if cfg.hybrid:
            self.ssm = SSM(cfg, device, ctx=ctx)
            self.attn_out_norm = RMSNorm(d, eps, device)
            self.ssm_out_norm = RMSNorm(d, eps, device)
            self.mix_attn = param((), torch.float32, device)
            self.mix_ssm = param((), torch.float32, device)
        if cfg.cross_attn_mode == "every":
            self.ln_x = RMSNorm(d, eps, device)
            self.attn_x = CrossAttention(cfg, device, ctx=ctx)
        self.ln2 = RMSNorm(d, eps, device)
        if cfg.is_moe and kind != "dense_ffn":
            self.moe = MoE(cfg, device, ctx=ctx)
        else:
            self.mlp = MLP(d, cfg.d_ff, dt, device, ctx=ctx)

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
            marks.backward("lm.moe.bwd", h, y)
            return x + y, aux
        with marks.span("lm.ffn.dense"):
            y = self.mlp(h, self.cfg.act)
        return x + y, aux

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
        with marks.span("lm.attn"):
            if self.cfg.use_mla:
                a_out, (c0, c1) = self.attn(h, positions=positions)
                entry = {"ckv": c0, "krope": c1}
            else:
                a_out, (c0, c1) = self.attn(h, positions=positions,
                                            window=window, theta=theta)
                entry = {"k": c0, "v": c1}
        marks.backward("lm.attn.bwd", h, a_out)
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
               window: int, theta: float, cond, seq_shard: bool = False):
        """One-token block; ``cache`` holds this layer's views, updated in
        place (``seq_shard``: its attention slots are this data rank's
        block of the sequence).  Returns (x, aux)."""
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.kind == "cross":
            return self._cross_layer(x, cond), zero
        h = self.ln1(x)
        if self.ssm_only:
            return x + self.ssm.decode(h, cache["ssm"], cache["conv"]), zero
        if self.cfg.use_mla:
            a_out = self.attn.decode(h, cache["ckv"], cache["krope"], pos,
                                     seq_shard=seq_shard)
        else:
            a_out = self.attn.decode(h, cache["k"], cache["v"], pos,
                                     window=window, theta=theta,
                                     seq_shard=seq_shard)
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
                 device: Device = None, rank: Optional[int] = None):
        super().__init__()
        dev = resolve_device(device)
        plan = layer_plan(cfg)
        self.cfg, self.plan, self.ctx = cfg, plan, ctx
        # this rank's place on the mesh (``rank`` where ``ctx`` has no
        # live ranks, as the converters build any rank's blocks)
        rank = ctx.rank if rank is None else int(rank)
        shard = (specs.axis_coords(ctx.mesh, rank)[ctx.model]
                 if ctx.mesh is not None and ctx.model else 0)
        self.layout = vocab_layout(cfg, ctx)
        dt = dtype_of(cfg)
        self.embed = Embedding(self.layout, cfg.d_model, dt, dev, ctx=ctx,
                               shard=shard)
        self.blocks = nn.ModuleList(Block(cfg, "main", dev, ctx=ctx)
                                    for _ in range(plan["main"]))
        if plan["dense"]:
            self.dense_blocks = nn.ModuleList(
                Block(cfg, "dense_ffn", dev, ctx=ctx)
                for _ in range(plan["dense"]))
        if plan["cross"]:
            self.cross_blocks = nn.ModuleList(
                Block(cfg, "cross", dev, ctx=ctx)
                for _ in range(plan["cross"]))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, dev)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(self.layout, cfg.d_model, dt, dev,
                                     ctx=ctx, shard=shard)
        self._dense_meta = layer_meta(cfg, plan["dense"], 0)
        self._main_meta = layer_meta(cfg, plan["main"], plan["dense"])
        if ctx.mesh is not None:
            for name, p in self.named_parameters():
                _attach_fill(name, p, cfg, ctx, rank)

    def set_capacity_factor(self, factor: float) -> None:
        """The expert-parallel path's capacity factor, in every MoE layer
        (the config's until set)."""
        for mod in self.modules():
            if isinstance(mod, MoE):
                mod.capacity_factor = float(factor)

    def moe_drops(self, reset: bool = False) -> List[Tuple[int, int]]:
        """Each MoE layer's (dropped, routed) (token, expert) pairs on this
        rank since the last reset, in run order."""
        out = [blk.moe.drops for _, _, blk, _, _ in self.schedule()
               if hasattr(blk, "moe")]
        if reset:
            for _, _, blk, _, _ in self.schedule():
                if hasattr(blk, "moe"):
                    blk.moe.drops = (0, 0)
        return out

    @property
    def head(self) -> Embedding:
        return self.lm_head if not self.cfg.tie_embeddings else self.embed

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _recompute_context(self):
        """``checkpoint``'s contexts: none for the forward; for the
        recompute in the backward, the MoE layers count no drops and the
        step's spans and counters mark nothing (all was counted once, in
        the forward)."""
        return contextlib.nullcontext(), _recomputing(self)

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
        x = self.embed(tokens)
        return scale_embeddings(x, self.cfg.d_model) if self.cfg.scale_embed \
            else x

    def forward(self, tokens: torch.Tensor, cond: Optional[torch.Tensor] = None,
                *, caches: Optional[dict] = None, head_at=None,
                remat: Optional[bool] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  tokens: [B, S].  Returns
        ``(logits_physical [B, S', Vpad], aux)``, S' the positions
        ``head_at`` selects (all by default).  With ``caches`` (an
        ``allocate_cache`` dict with at least S slots) each layer's K/V and
        SSM state are written into it (a sequence-sharded one: the positions
        of this rank's slot block).  ``remat`` (default ``cfg.remat``)
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
        seq_shard = getattr(caches, "seq_shard", False)
        positions = torch.arange(s, dtype=torch.int64, device=tokens.device)
        x = self._embed(tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for stack, i, blk, win, th in self.schedule():
            if remat:
                x, a = checkpoint(_layer_out, blk, x, positions, win, th,
                                  cond, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=self._recompute_context)
                aux = aux + a
                continue
            x, entry, a = blk.full(x, positions=positions, window=win,
                                   theta=th, cond=cond)
            aux = aux + a
            if caches is not None and stack is not None:
                for name, val in entry.items():
                    dst = caches[stack][name][i]
                    if name not in SEQ_LEAVES:
                        dst.copy_(val)
                    elif not seq_shard:
                        dst[:, :s].copy_(val)
                    else:
                        base = self.ctx.comm.data_idx * dst.shape[1]
                        n = max(0, min(s, base + dst.shape[1]) - base)
                        dst[:, :n].copy_(val[:, base:base + n])
        with marks.span("lm.head"):
            x = self.final_norm(x if head_at is None else x[:, head_at])
            return lm_head_logits(self.head, x), aux

    def decode_step(self, token: torch.Tensor, caches: dict, pos: int,
                    cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step.  token: [B] int; ``pos`` (a Python int) is the
        position being written.  Returns logits [B, Vpad]; the caches are
        updated in place (sequence-sharded ones: by the data rank that owns
        slot ``pos``)."""
        seq_shard = getattr(caches, "seq_shard", False)
        x = self._embed(token[:, None])
        for stack, i, blk, win, th in self.schedule():
            view = ({} if stack is None else
                    {name: t[i] for name, t in caches[stack].items()})
            x, _ = blk.decode(x, view, pos, window=win, theta=th, cond=cond,
                              seq_shard=seq_shard)
        return lm_head_logits(self.head, self.final_norm(x))[:, 0]


# ---------------------------------------------------------------------------
# Mesh layouts of the parameters
# ---------------------------------------------------------------------------

def _cyclic_kind(name: str) -> Optional[str]:
    """Which leaves the mesh stores in its cyclic row order: the vocab
    tables (rows = tokens) and the expert stacks (rows = experts)."""
    path = specs.path_str(name)
    if path.endswith(("embed/table", "lm_head/table")):
        return "vocab"
    if "/experts/" in path:
        return "experts"
    return None


def shard_leaf(name: str, full: torch.Tensor, cfg: ModelConfig,
               ctx: MeshCtx, rank: int) -> torch.Tensor:
    """Rank ``rank``'s block of parameter ``name`` from its single-device
    (logical) value ``full``: the block of ``specs.port_spec`` (the rules'
    but for an SSM mixer split by heads, whose per-head leaves split by
    heads and whose ``in_proj``/``conv_w``/``conv_b`` columns are
    regrouped, ``ssm.to_rank_columns``), the vocab table's rows and the
    expert stack's experts taken in the mesh's cyclic order (logical row
    ``v`` of ``M`` shards lives on shard ``v mod M``; a vocab shard's rows
    past the vocabulary are zero)."""
    m = ctx.model_size
    spec = specs.port_spec(specs.path_str(name), full.dim(), ctx, cfg)
    kind = _cyclic_kind(name)
    if kind is None:
        if ssm_mod.regrouped(name, cfg, m):
            full = ssm_mod.to_rank_columns(name, full, cfg, m)
        return specs.local_shard(full, spec, ctx.mesh, rank)
    i = specs.axis_coords(ctx.mesh, rank)[ctx.model]
    if kind == "vocab":
        lay = VocabLayout(cfg.vocab_size, m, cfg.vocab_layout)
        rows = lay.pad_rows // m
        if lay.mode == "blocked":
            out = full[i * rows:(i + 1) * rows]
        else:
            out = full[i::m]
        if out.shape[0] < rows:
            out = torch.cat([out, out.new_zeros((rows - out.shape[0],
                                                 *out.shape[1:]))])
        return out
    rest = specs.P(None, *spec[1:])
    return specs.local_shard(full[i::m], rest, ctx.mesh, rank)


def unshard_leaf(name: str, blocks: List[torch.Tensor], cfg: ModelConfig,
                 ctx: MeshCtx, spec=None) -> torch.Tensor:
    """The inverse of ``shard_leaf``: the single-device (logical) value of
    parameter ``name`` from every rank's block, in rank order; ``spec``
    places the blocks (``specs.port_spec`` by default; a ZeRO moment's
    are its ``opt_state_specs``)."""
    mesh = ctx.mesh
    if spec is None:
        spec = specs.port_spec(specs.path_str(name), blocks[0].dim(), ctx,
                               cfg)
    kind = _cyclic_kind(name)
    shape = list(blocks[0].shape)
    grid = [specs.shard_grid(spec, mesh, r) for r in range(len(blocks))]
    for dim, (n, _) in enumerate(grid[0]):
        shape[dim] *= n
    phys = blocks[0].new_empty(shape)
    for r, blk in enumerate(blocks):
        index = tuple(slice(i * blk.shape[d], (i + 1) * blk.shape[d])
                      for d, (_, i) in enumerate(grid[r]))
        phys[index] = blk
    if ssm_mod.regrouped(name, cfg, ctx.model_size):
        return ssm_mod.from_rank_columns(name, phys, cfg, ctx.model_size)
    return phys if kind is None else \
        from_cyclic_rows(name, phys, cfg, ctx.model_size)


def _row_map(name: str, rows: int, cfg: ModelConfig, m: int):
    """(physical rows of the ``m``-shard layout, physical index of each
    logical row) of a vocab table or expert stack."""
    if _cyclic_kind(name) == "vocab":
        lay = VocabLayout(cfg.vocab_size, m, cfg.vocab_layout)
        return lay.pad_rows, torch.as_tensor(lay.to_physical(
            torch.arange(cfg.vocab_size)))
    return rows, torch.as_tensor(CyclicLayout(rows, m).to_physical(
        torch.arange(rows)))


def from_cyclic_rows(name: str, phys: torch.Tensor, cfg: ModelConfig,
                     m: int) -> torch.Tensor:
    """A vocab table's or expert stack's logical rows from the
    ``m``-shard cyclic layout (other leaves unchanged)."""
    if _cyclic_kind(name) is None:
        return phys
    return phys[_row_map(name, phys.shape[0], cfg, m)[1]]


def to_cyclic_rows(name: str, logical: torch.Tensor, cfg: ModelConfig,
                   m: int) -> torch.Tensor:
    """The inverse of ``from_cyclic_rows``; padding rows are zero."""
    if _cyclic_kind(name) is None:
        return logical
    rows, idx = _row_map(name, logical.shape[0], cfg, m)
    out = logical.new_zeros((rows, *logical.shape[1:]))
    out[idx] = logical
    return out


def _attach_fill(name: str, p: torch.Tensor, cfg: ModelConfig,
                 ctx: MeshCtx, rank: int) -> None:
    """Check that ``p`` is ``shard_leaf``'s block of its single-device
    leaf (the rules', or the SSM's regrouped columns), and let
    ``layers.normal_``/``fill_`` fill it from a whole value."""
    probe = torch.empty(p._full_shape, device="meta")
    want = tuple(shard_leaf(name, probe, cfg, ctx, rank).shape)
    if want != tuple(p.shape):
        raise AssertionError(f"{name}: block {tuple(p.shape)}, the rules "
                             f"give {want}")
    p._mesh_fill = lambda full: shard_leaf(name, full, cfg, ctx, rank)


@contextlib.contextmanager
def _recomputing(model: Transformer):
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    for m in moes:
        m.count_drops = False
    try:
        with marks.paused():
            yield
    finally:
        for m in moes:
            m.count_drops = True


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
    distributions, not its bits: parity starts from carried weights.  On
    a mesh each leaf is drawn whole, in the single-device order, and this
    rank keeps its block: the logical weights are the single-device
    model's of the same seed on the same device type."""
    model = Transformer(cfg, ctx, device)
    g = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=model.device).manual_seed(int(seed))
    model.reset_parameters(g)
    return model


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int,
                 ctx: MeshCtx = SINGLE, seq_shard: bool = False) -> dict:
    """``registry.cache_shapes`` of one rank: on a mesh ``batch`` is its
    data slice (``seq_shard``: the whole batch, and each attention and MLA
    leaf holds the rank's ``ceil(seq_len / dp)`` slots), the KV leaves
    hold its KV heads (``attention.cache_kv_heads``), the SSM state and
    conv tail its heads and channels (``ssm.SSM``: split by heads, or
    whole); the MLA latent stays whole."""
    if seq_shard:
        seq_len = -(-seq_len // ctx.dp_size)
    out = registry.cache_shapes(cfg, batch, seq_len)
    heads = cache_kv_heads(cfg, ctx.model_size)
    m = ctx.model_size
    tp = cfg.ssm_state > 0 and m > 1 and specs.ssm_split(cfg, m) == "heads"
    for leaves in out.values():
        for name in ("k", "v"):
            if name in leaves:
                shape, dt = leaves[name]
                leaves[name] = (shape[:3] + (heads,) + shape[4:], dt)
        if tp and "ssm" in leaves:
            (n, b, h, p, st), dt = leaves["ssm"]
            leaves["ssm"] = ((n, b, h // m, p, st), dt)
            (n, b, w, _), dt = leaves["conv"]
            leaves["conv"] = ((n, b, w, cfg.d_inner // m + 2 * cfg.ssm_state),
                              dt)
    return out


class Caches(dict):
    """Decode caches, ``{stack: {leaf: [L, B, ...]}}`` (``allocate_cache``).
    ``seq_shard``: sequence-sharded over the data axis, each attention and
    MLA leaf holding this data rank's block of the slots; the model reads
    it from here, so a cache and its layout cannot disagree."""

    def __init__(self, stacks=(), seq_shard: bool = False):
        super().__init__(stacks)
        self.seq_shard = seq_shard


def allocate_cache(cfg: ModelConfig, batch: int, seq_len: int,
                   device: Device = None, ctx: MeshCtx = SINGLE,
                   seq_shard: bool = False) -> Caches:
    """Zeroed decode caches of ``seq_len`` slots, shaped by
    ``cache_shapes``."""
    dev = resolve_device(device)
    return Caches({stack: {name: torch.zeros(shape, dtype=dt, device=dev)
                           for name, (shape, dt) in leaves.items()}
                   for stack, leaves in cache_shapes(cfg, batch, seq_len, ctx,
                                                     seq_shard).items()},
                  seq_shard)


def forward(model: Transformer, tokens: torch.Tensor,
            cond: Optional[torch.Tensor] = None, want_cache: bool = False,
            remat: Optional[bool] = None):
    """Full-sequence forward.  Returns ``(logits_physical [B, S, Vpad], aux,
    caches or None)``, the caches S slots long."""
    caches = (allocate_cache(model.cfg, tokens.shape[0], tokens.shape[1],
                             model.device, model.ctx) if want_cache else None)
    logits, aux = model(tokens, cond, caches=caches, remat=remat)
    return logits, aux, caches


def loss_fn(model: Transformer, tokens: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor, cond: Optional[torch.Tensor] = None,
            remat: Optional[bool] = None):
    """Masked mean cross-entropy over the physical logits plus
    ``router_aux_weight`` times the MoE load-balance loss.  Returns
    ``(loss, {"xent", "aux"})``.  On a mesh the batch is this rank's data
    slice, the cross-entropy is vocab-parallel and the loss is the whole
    batch's (``layers.softmax_xent_sharded``; the MoE's ``aux`` is the
    whole batch's too), the same on every rank."""
    logits, aux = model(tokens, cond, remat=remat)
    with marks.span("lm.head"):
        if model.ctx.comm is None:
            xent = softmax_xent_physical(logits, targets, model.layout, mask)
        else:
            xent = softmax_xent_sharded(logits, targets, model.layout, mask,
                                        model.ctx, model.head.shard)
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
                                model.device, model.ctx)
    logits, _ = model(tokens, cond, caches=caches, head_at=slice(-1, None),
                      remat=False)
    return logits[:, 0], caches


def decode_step(model: Transformer, token: torch.Tensor, caches: dict,
                pos: int, cond: Optional[torch.Tensor] = None):
    """One decode step.  Returns ``(logits [B, Vpad], caches)``, the caches
    updated in place."""
    return model.decode_step(token, caches, pos, cond), caches
