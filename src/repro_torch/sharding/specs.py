"""Partition rules: parameters, optimizer state, activations, caches.

The twin of the JAX package's ``sharding/specs.py``.  Rules are keyed on
parameter *path suffixes* (the module path joined by ``/``, spelled as the
JAX tree's: ``blocks/0/attn/wq``), so every architecture flows through one
table.  The mesh has axes ``(pod?, data, model)``; ``MeshCtx`` carries the
axis names so the same model code runs on one device (``SINGLE``) and on a
mesh of ranks (``launch.mesh.Mesh``).

Layout summary (the reference's DESIGN.md section 5):
  embed/lm_head tables   : P(model, None)   -- vocab rows, cyclic physical order
  attn wq/wk/wv          : P(None, model)   -- shard heads
  attn wo                : P(model, None)
  mlp w_gate/w_up        : P(None, model)   -- shard d_ff
  mlp w_down             : P(model, None)
  MoE experts            : P(model, dp, None) -- expert-parallel (cyclic owners)
  MLA w_dkv (latent)     : replicated       (latent dim is small and shared)
  MLA w_uk/w_uv          : P(None, model)
  ssm in_proj/out_proj   : P(None, model) / P(model, None)  -- shard d_inner
  norms / scalars / router: replicated

The reference hands these specs to GSPMD, which inserts the collectives.
The port places each rank's block itself (``local_shard``) and its layers
issue the collectives explicitly (``models/layers.py``), so
``MeshCtx.constrain`` only asserts that a spec names the mesh's axes.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np

from repro_torch.configs.base import InputShape, ModelConfig


class P(tuple):
    """A partition spec: one entry per leading dim, each ``None``
    (replicated), an axis name, or a tuple of axis names (the reference's
    ``jax.sharding.PartitionSpec``, whose ``tuple()`` equals this one's:
    a one-axis tuple reads as the axis)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Mesh + axis roles.  ``mesh is None`` means single-device semantics.
    ``mesh`` is anything with ``axis_names`` and ``devices`` (an array
    shaped by the axes): a rank's ``launch.mesh.Mesh``, whose collectives
    the layers call, or a ``launch.mesh.MeshLayout`` for the rules alone."""

    mesh: Optional[object]
    dp: Tuple[str, ...]          # data-parallel axes, e.g. ("pod", "data")
    model: Optional[str]         # tensor/expert-parallel axis

    def _sizes(self) -> dict:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))

    @property
    def num_devices(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.devices.size)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        sizes = self._sizes()
        out = 1
        for ax in self.dp:
            out *= sizes[ax]
        return out

    @property
    def model_size(self) -> int:
        if self.mesh is None or self.model is None:
            return 1
        return self._sizes()[self.model]

    @property
    def comm(self):
        """The rank's ``Mesh`` whose collectives the layers call, or None
        (one device, or a layout without ranks)."""
        return self.mesh if hasattr(self.mesh, "all_reduce") else None

    @property
    def rank(self) -> int:
        return int(getattr(self.mesh, "rank", 0))

    def constrain(self, x, spec: P):
        """The reference's ``with_sharding_constraint``.  The port's layers
        hold each rank's block explicitly, so this only asserts that
        ``spec`` fits ``x`` and names axes of the mesh."""
        if self.mesh is None:
            return x
        names = set(self.mesh.axis_names)
        assert len(spec) <= x.ndim, (spec, tuple(x.shape))
        for part in spec:
            for ax in (part if isinstance(part, tuple) else (part,)):
                assert ax is None or ax in names, (ax, names)
        return x


SINGLE = MeshCtx(None, (), None)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

def _param_rules(model_axis: str):
    """(regex on '/'-joined path, spec builder taking leaf ndim)."""
    m = model_axis

    def two(a, b):
        # spec for the *trailing two* dims; leading (stacked layer) dims None
        return lambda nd: P(*([None] * (nd - 2) + [a, b]))

    def three(a, b, c):
        return lambda nd: P(*([None] * (nd - 3) + [a, b, c]))

    def repl(nd):
        return P()

    return [
        (r"embed/table$", two(m, None)),
        (r"lm_head/table$", two(m, None)),
        # Experts: expert dim over the model axis (cyclic owners), and the
        # d_model dim ZeRO-sharded over the dp axes for storage -- gathered
        # per use inside the MoE (models/moe.py)
        (r"experts/w_gate$", three(m, "__dp__", None)),
        (r"experts/w_up$", three(m, "__dp__", None)),
        (r"experts/w_down$", three(m, "__dp__", None)),
        (r"router$", repl),
        (r"attn.*/wq$", two(None, m)),
        (r"attn.*/wk$", two(None, m)),
        (r"attn.*/wv$", two(None, m)),
        (r"attn.*/wo$", two(m, None)),
        (r"attn.*/w_dkv$", repl),          # MLA latent down-proj: small, replicated
        (r"attn.*/w_uk$", two(None, m)),
        (r"attn.*/w_uv$", two(None, m)),
        (r"(mlp|shared)/w_gate$", two(None, m)),
        (r"(mlp|shared)/w_up$", two(None, m)),
        (r"(mlp|shared)/w_down$", two(m, None)),
        (r"ssm/in_proj$", two(None, m)),
        (r"ssm/out_proj$", two(m, None)),
        (r"ssm/conv_w$", two(None, m)),
        (r"ssm/conv_b$", lambda nd: P(*([None] * (nd - 1) + [m]))),
        (r".*", repl),                     # norms, scalars, biases, gates
    ]


def ssm_split(cfg: ModelConfig, m: int) -> str:
    """How the port splits an SSM mixer over a model axis of ``m``:
    ``"heads"`` where the SSD heads tile the axis (mamba2-370m's 32 heads
    on 2 or 4, hymba-1.5b's 50 on 2): each rank runs its heads, holding
    its ``z``/``x`` columns and the shared ``B``/``C`` ones regrouped
    (``models/ssm.py``); else ``"gather"`` (hymba's 50 on 4): the rules'
    contiguous blocks, all-gathered per use, the whole mixer on every
    rank -- the split ``models/attention.attn_split`` makes for heads."""
    return "heads" if m == 1 or cfg.ssm_heads % m == 0 else "gather"


# the SSM leaves the port splits over the model axis by heads in "heads"
# mode, where the rules replicate them (the port's own layout)
_SSM_HEAD_LEAVES = re.compile(
    r"ssm/(dt_proj|A_log|D|dt_bias|gate_norm/scale)$")


def port_spec(path: str, ndim: int, ctx: MeshCtx, cfg=None) -> P:
    """The spec of the block a port module holds: the rules' (``spec_for``)
    but for an SSM mixer split by heads (``ssm_split``), whose per-head
    leaves (``dt_proj``'s columns, ``A_log``, ``D``, ``dt_bias``, the
    gate norm's scale) split over the model axis on their last dim.
    Its ``in_proj``/``conv_w``/``conv_b`` keep the rules' spec over the
    port's regrouped columns (``models/ssm.py``)."""
    spec = spec_for(path, ndim, ctx)
    if (cfg is not None and cfg.ssm_state and ctx.model_size > 1
            and ssm_split(cfg, ctx.model_size) == "heads"
            and _SSM_HEAD_LEAVES.search(path)):
        return P(*([None] * (ndim - 1) + [ctx.model]))
    return spec


def path_str(name: str) -> str:
    """A module's parameter name (``blocks.0.attn.wq``) as a rule path."""
    return name.replace(".", "/")


def spec_for(path: str, ndim: int, ctx: MeshCtx) -> P:
    """The spec of the leaf at ``path`` ('/'-joined) with ``ndim`` dims."""
    if ctx.mesh is None or ctx.model is None:
        return P()
    for pat, builder in _param_rules(ctx.model):
        if re.search(pat, path):
            spec = builder(ndim)
            # resolve the "__dp__" placeholder to this mesh's dp axes
            return P(*(tuple(ctx.dp) if p == "__dp__" else p for p in spec))
    return P()


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn("/".join(path), tree)


class _Shape(tuple):
    """A module leaf's shape and the spec of its blocks."""

    spec = None

    @property
    def shape(self):
        return tuple(self)


def _leaves(params, ctx: "MeshCtx"):
    """``params`` as a nested dict (the JAX tree's layout) or a module,
    whose parameters become ``{'/'-path: shape}``: on a mesh the shape of
    the leaf the blocks make up (a block's shape times its split under
    ``port_spec``), which is the reference's leaf but for an SSM mixer
    split by heads (its regrouped columns)."""
    if not hasattr(params, "named_parameters"):
        return params
    cfg = getattr(params, "cfg", None)
    out = {}
    for n, p in params.named_parameters():
        path = path_str(n)
        shape = tuple(p.shape)
        spec = port_spec(path, len(shape), ctx, cfg)
        if ctx.mesh is not None:
            grid = shard_grid(spec, ctx.mesh, 0)
            shape = tuple(s * g[0] for s, g in zip(shape, grid)) + \
                shape[len(grid):]
        leaf = _Shape(shape)
        leaf.spec = spec
        out[path] = leaf
    return out


def _leaf_spec(path: str, leaf, ctx: MeshCtx) -> P:
    spec = getattr(leaf, "spec", None)
    return spec_for(path, len(leaf.shape), ctx) if spec is None else spec


# a module's layer-stack leaves (``blocks/3/attn/wq``): the reference
# stacks them as ``[L, ...]``
_STACKED = re.compile(r"^(blocks|dense_blocks|cross_blocks)/\d+/")


def stacked(path: str) -> bool:
    """Whether a module's leaf at ``path`` is one layer of a stack."""
    return bool(_STACKED.match(path))


def param_specs(params, ctx: MeshCtx):
    """Spec tree matching ``params``: a nested dict of leaves with
    ``.ndim`` (numpy arrays, tensors, ``jax.ShapeDtypeStruct``), or a
    module (then ``{path: spec}``)."""
    return _tree_map(lambda p, leaf: _leaf_spec(p, leaf, ctx),
                     _leaves(params, ctx))


def opt_state_specs(params, ctx: MeshCtx):
    """ZeRO-style specs for optimizer moments / gradient accumulators:
    the parameter's spec, additionally sharded over the dp axes on the
    first dp-divisible dim the parameter spec leaves None (dims 1.., then
    0), unless it already uses a dp axis.  A module's layer-stack leaf is
    one layer of the reference's ``[L, ...]`` stack, whose dims 1.. are
    its dims: it takes the stack's choice (its dims in order), and where
    the stack would split its ``L`` it stays whole."""
    if ctx.mesh is None:
        return param_specs(params, ctx)
    dp = tuple(ctx.dp)
    dpsz = ctx.dp_size

    def widen(path, leaf):
        shape = tuple(leaf.shape)
        spec = _leaf_spec(path, leaf, ctx)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        used = set()
        for p in parts:
            for ax in (p if isinstance(p, tuple) else (p,)):
                used.add(ax)
        if any(a in used for a in dp):
            return P(*parts)
        order = list(range(len(shape))) if stacked(path) else \
            list(range(1, len(shape))) + [0]
        for i in order:
            if parts[i] is None and shape[i] and shape[i] % dpsz == 0:
                parts[i] = dp
                return P(*parts)
        return P(*parts)

    return _tree_map(widen, _leaves(params, ctx))


# ---------------------------------------------------------------------------
# This rank's block
# ---------------------------------------------------------------------------

def axis_coords(mesh, rank: int) -> dict:
    """``{axis name: index}`` of ``rank`` in a row-major mesh."""
    shape = tuple(mesh.devices.shape)
    return dict(zip(mesh.axis_names,
                    (int(i) for i in np.unravel_index(rank, shape))))


def _part_axes(part) -> tuple:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def shard_grid(spec: P, mesh, rank: int) -> list:
    """Per leading dim: ``(number of shards, this rank's index)``."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    coords = axis_coords(mesh, rank)
    out = []
    for part in spec:
        n, idx = 1, 0
        for ax in _part_axes(part):
            idx = idx * sizes[ax] + coords[ax]
            n *= sizes[ax]
        out.append((n, idx))
    return out


def local_shape(shape, spec: P, mesh, what: str = "leaf") -> tuple:
    """The block shape of a ``shape`` leaf under ``spec``; raises when a
    split dim does not divide."""
    if mesh is None:
        return tuple(shape)
    out = list(shape)
    for dim, (n, _) in enumerate(shard_grid(spec, mesh, 0)):
        if out[dim] % n:
            raise ValueError(f"{what}: dim {dim} of {tuple(shape)} does not "
                             f"split into {n} shards ({spec})")
        out[dim] //= n
    return tuple(out)


def local_shard(leaf, spec: P, mesh, rank: int):
    """This rank's block of a full array (a tensor or numpy array): each
    split dim cut into equal contiguous blocks in the row-major order of
    the spec's axes (a view where the array allows one)."""
    if mesh is None:
        return leaf
    local_shape(tuple(leaf.shape), spec, mesh)
    index = []
    for dim, (n, i) in enumerate(shard_grid(spec, mesh, rank)):
        step = leaf.shape[dim] // n
        index.append(slice(i * step, (i + 1) * step))
    return leaf[tuple(index)]


# ---------------------------------------------------------------------------
# Activation / cache / batch rules
# ---------------------------------------------------------------------------

def batch_spec(ctx: MeshCtx) -> P:
    return P(tuple(ctx.dp)) if ctx.dp else P()


# Residual-stream sharding between blocks in the reference ("dp_model":
# d_model over the model axis).  The port keeps the hidden replicated over
# the model axis (each rank holds its data slice whole); the constant is
# kept for ``hidden_spec``'s callers.
ACTIVATION_SHARDING = "dp_model"


def hidden_spec(ctx: MeshCtx, cfg=None) -> P:
    if not ctx.dp:
        return P()
    mode = (cfg.activation_sharding if cfg is not None
            and getattr(cfg, "activation_sharding", "") else
            ACTIVATION_SHARDING)
    if mode == "dp_seq" and ctx.model is not None:
        return P(tuple(ctx.dp), ctx.model, None)
    if mode == "dp_model" and ctx.model is not None:
        return P(tuple(ctx.dp), None, ctx.model)
    return P(tuple(ctx.dp), None, None)


def tokens_spec(ctx: MeshCtx) -> P:
    return P(tuple(ctx.dp), None) if ctx.dp else P()


def cache_specs(cfg: ModelConfig, shape: InputShape, ctx: MeshCtx):
    """The reference's specs of the decode caches, keyed by cache kind.

    For a batch smaller than the dp size (long_500k) the attention caches
    are sequence-sharded over the data axes, else batch-sharded; the
    reference splits ``head_dim`` (KV), the latent (MLA) and the SSM head
    dim ``P`` over the model axis.  The port's engine holds the same
    per-rank bytes by other splits (``transformer.cache_shapes``): whole
    KV heads over the model axis where they tile it
    (``models/attention.py``); the MLA latent and, where KV heads do not
    tile the axis, the KV heads are kept whole on every model rank (their
    absorbed decode reads all of the latent per local head).  An SSM
    mixer split by heads (``ssm_split``) holds its heads' state ``[B,
    H/M, P, N]`` -- the reference's bytes, split over ``H`` instead of
    ``P`` -- and its conv tail ``[B, W-1, d_inner/M + 2N]`` (its
    channels and the shared ``B``/``C`` ones); split by ``"gather"`` it
    holds both whole.  The sequence-sharded case is served: data rank
    ``j`` of ``dp`` holds slots ``[j S', (j+1) S')`` of every attention
    and MLA cache, ``S' = ceil(S / dp)`` (padded as a ``NamedSharding``
    pads), the batch and the SSM state whole on every data rank, and a
    decode step combines the ranks' partial softmax statistics
    (``layers.lse_combine``)."""
    if ctx.mesh is None:
        none = P()
        return {"kv": none, "mla": none, "ssm_state": none, "conv": none,
                "seq_axis_sharded": False}
    dp = tuple(ctx.dp)
    m = ctx.model
    seq_shard = shape.global_batch < ctx.dp_size
    if seq_shard:
        kv = P(None, None, dp, None, m)
        mla = P(None, None, dp, m)
        ssm_state = P(None, None, None, m, None)
        conv = P(None, None, None, m)
    else:
        kv = P(None, dp, None, None, m)
        mla = P(None, dp, None, m)
        ssm_state = P(None, dp, None, m, None)
        conv = P(None, dp, None, m)
    return {"kv": kv, "mla": mla, "ssm_state": ssm_state, "conv": conv,
            "seq_axis_sharded": seq_shard}
