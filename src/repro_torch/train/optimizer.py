"""Hand-rolled optimizers: AdamW with a warmup-cosine schedule and
global-norm clipping, the twin of the JAX package's ``train/optimizer.py``.

Parameters, gradients and moments are dicts of tensors keyed by the model's
parameter names (``dict(model.named_parameters())``).  The moments are
float32; each parameter is updated in its own dtype, with no float32 master
copy; the schedule and the bias corrections are float32 tensors, as the
reference computes them.

The reference is functional.  Here ``apply`` updates the parameters and
moments in place, a slice of rows at a time (``row_slices``), with the
reference's operations in its order: at gemma3-4b's 262,144 x 2,560
embedding every float32 temporary of the whole leaf would be 2.7 GB.
Weight decay applies to the leaves the reference decays: those of two or
more dims in its tree, where a layer's leaf is one slice of an ``[L,
...]`` stack (so a layer's norm scale is decayed, a layer's scalar gate
is not).

**On a mesh** (``Zero``) each rank holds its block of every parameter
and its ZeRO block of the moments: the block cut once more over the data
axis on the dim ``sharding.specs.opt_state_specs`` names.  A gradient
reaches the moments reduce-scattered over the data axis onto that dim
(all-reduced where there is none; as it is where the parameter's own
spec already splits over data, the experts, whose gather's backward did
the sum); AdamW updates the rank's slice of the parameter, and an
all-gather over the data axis rebuilds the block.  The global norm adds
each leaf's squares once: a block's local sum is divided by the number
of ranks that hold the same block (the SSM's shared ``B``/``C`` columns,
held alike by every model rank, once more by the model size), and one
all-reduce over the world adds them.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.sharding import specs

F32 = torch.float32
# elements of one slice of a leaf: its float32 temporaries are 64 MB each
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor           # int32 scalar


def row_slices(t: torch.Tensor) -> Iterator:
    """Indices that cut ``t`` into slices of whole rows of at most ``CHUNK``
    elements (one slice, ``...``, when it is that small or a scalar)."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        yield ...
        return
    rows = max(1, CHUNK // max(t[0].numel(), 1))
    for r in range(0, t.shape[0], rows):
        yield slice(r, r + rows)


class ZeroLeaf(NamedTuple):
    dim: Optional[int]           # the dim ZeRO splits over data, or None
    in_param: bool               # the parameter's own spec splits over data
    copies: int                  # ranks that hold the same moment block
    shared: int = 0              # trailing columns every model rank holds


class Zero:
    """ZeRO over the data axis for one rank: where each leaf's moments
    live and how its gradient reaches them.  ``model`` holds the rank's
    blocks; ``ctx`` its mesh (with collectives, ``ctx.comm``, to reduce
    and rebuild; a ``MeshLayout`` gives the shapes alone)."""

    def __init__(self, model: torch.nn.Module, ctx: specs.MeshCtx):
        self.comm = ctx.comm
        # this rank's place on the data axes
        self.data, self.index = specs.shard_grid(
            specs.P(tuple(ctx.dp)), ctx.mesh, ctx.rank)[0]
        world = ctx.num_devices
        pspecs = specs.param_specs(model, ctx)
        ospecs = specs.opt_state_specs(model, ctx)
        self.leaves: Dict[str, ZeroLeaf] = {}
        for name, p in model.named_parameters():
            path = specs.path_str(name)
            nd = p.dim()
            pp = list(pspecs[path]) + [None] * (nd - len(pspecs[path]))
            oo = list(ospecs[path]) + [None] * (nd - len(ospecs[path]))
            dim = next((i for i in range(nd) if pp[i] != oo[i]), None)
            in_param = any(ax in ctx.dp for part in pp if part is not None
                           for ax in (part if isinstance(part, tuple)
                                      else (part,)))
            shards = math.prod(n for n, _ in specs.shard_grid(
                ospecs[path], ctx.mesh, 0))
            self.leaves[name] = ZeroLeaf(dim, in_param, world // shards,
                                         getattr(p, "_model_shared", 0))
        self.model = ctx.model_size

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO slice of a parameter-block-shaped ``t`` (a
        view)."""
        dim = self.leaves[name].dim
        if dim is None:
            return t
        n = t.shape[dim] // self.data
        return t.narrow(dim, self.index * n, n)

    def reduce(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A rank's gradient of a parameter block -> the float32 ZeRO
        slice of its sum over the data axis (a new tensor)."""
        lf = self.leaves[name]
        g = g.to(F32)
        if lf.in_param or self.data == 1:
            return g
        if lf.dim is None:
            return self.comm.all_reduce(g, "data", "grad_sum")
        out = self.comm.reduce_scatter(g.movedim(lf.dim, 0), "data",
                                       "grad_rs")
        return out.movedim(0, lf.dim).contiguous()

    def rebuild(self, name: str, p: torch.Tensor) -> None:
        """After the rank updated its slice of ``p``: every data rank's
        slice gathered back into the block, in place."""
        dim = self.leaves[name].dim
        if dim is None or self.data == 1:
            return
        with torch.no_grad():
            p.copy_(self.comm.all_gather_dim(self.local(name, p), "data",
                                             dim, "param_gather"))

    def sum_sq(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A block's local sum of squares, its trailing ``shared`` columns
        (the SSM's ``B``/``C``, the same on every model rank: ``models/
        ssm.py``) counted once over the model axis."""
        k = self.leaves[name].shared
        if not k:
            return _sum_sq(x)
        return _sum_sq(x[..., :-k]) + _sum_sq(x[..., -k:]) / self.model

    def norm(self, sq: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm from each leaf's local sum of squares."""
        total = sum(s / self.leaves[n].copies for n, s in sq.items())
        total = total.reshape(1)
        if self.comm is not None and self.comm.world > 1:
            total = self.comm.all_reduce(total, ("data", "model"),
                                         "grad_norm")
        return torch.sqrt(total[0])


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether AdamW decays leaf ``name``: two or more dims in the
    reference's tree, a layer's leaf counting its stack's dim."""
    return p.dim() + bool(specs.stacked(specs.path_str(name))) >= 2


def init(params: Dict[str, torch.Tensor],
         zero: Optional[Zero] = None) -> AdamWState:
    """Zero moments, each the parameter's shape (on a mesh its ZeRO
    block, ``zero``)."""
    def zeros():
        return {n: torch.zeros(p.shape if zero is None else
                               zero.local(n, p).shape, dtype=F32,
                               device=p.device)
                for n, p in params.items()}

    dev = next(iter(params.values())).device
    return AdamWState(zeros(), zeros(),
                      torch.zeros((), dtype=torch.int32, device=dev))


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    step = step.to(F32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(torch.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    sq = None
    for sl in row_slices(x):
        c = x[sl].to(F32)
        s = torch.sum(c * c)
        sq = s if sq is None else sq + s
    return sq


def global_norm(tree: Dict[str, torch.Tensor],
                zero: Optional[Zero] = None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a slice of rows
    at a time, so a bf16 leaf is never widened whole).  With ``zero`` the
    leaves are a rank's ZeRO slices: each counted once over the mesh."""
    if zero is not None:
        return zero.norm({n: zero.sum_sq(n, x) for n, x in tree.items()})
    sq = None
    for x in tree.values():
        s = _sum_sq(x)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    # ``max_norm / t`` on a tensor is a product with t's reciprocal in
    # PyTorch; the reference divides
    return torch.clamp(torch.full_like(gn, max_norm)
                       / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def apply(grads: Dict[str, torch.Tensor], state: AdamWState,
          params: Dict[str, torch.Tensor], tc: TrainConfig,
          zero: Optional[Zero] = None
          ) -> Tuple[Dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step, in place: ``params`` and the moments are updated and
    returned with the new step count.  Weight decay applies to the
    reference's >=2-D leaves (``decays``).  ``grads`` are read, never
    written; the clip multiplies in each gradient's own dtype, as the
    reference's ``clip_by_global_norm`` does.  On a mesh (``zero``) the
    gradients and moments are the rank's ZeRO slices (``Zero.reduce``)
    and each parameter block is rebuilt after its slice's update."""
    gn = global_norm(grads, zero)
    scale = _clip_scale(gn, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, tc)
    b1, b2 = tc.beta1, tc.beta2
    c1 = 1.0 - torch.pow(b1, step.to(F32))
    c2 = 1.0 - torch.pow(b2, step.to(F32))

    for name, p in params.items():
        g, m, v = grads[name], state.m[name], state.v[name]
        sg = scale.to(g.dtype)
        own = p if zero is None else zero.local(name, p)
        decay = decays(name, p)
        for sl in row_slices(own):
            g32 = (g[sl] * sg).to(F32)
            mi, vi = m[sl], v[sl]
            mi.mul_(b1).add_(g32 * (1 - b1))       # b1 m + (1 - b1) g
            vi.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            delta = (mi / c1).div_((vi / c2).sqrt_().add_(tc.eps))
            p32 = own[sl].to(F32)
            if decay:
                delta.add_(p32 * tc.weight_decay)
            own[sl].copy_(p32 - delta.mul_(lr))
        if zero is not None:
            zero.rebuild(name, p)
    return params, AdamWState(state.m, state.v, step), \
        {"lr": lr, "grad_norm": gn}


def first_step_band(g: torch.Tensor, scale: float, lr: float, eps: float,
                    rtol: float, atol: float) -> torch.Tensor:
    """How far the first ``apply`` (zero moments) can move each element
    of a parameter whose gradient is known only to within ``atol`` of the
    leaf's largest plus ``rtol`` of ``g``: the step moves it by lr times
    ``x / (|x| + eps)`` of the clipped gradient ``x = g * scale``, so by
    lr times that function's range over the tolerance -- up to 2 lr where
    the tolerance spans 0 (a near-zero gradient takes either sign), less
    where it does not.  Float32, ``g``'s shape."""
    g = g.abs().double()
    tol = atol * float(g.max()) + rtol * g
    a, t = g * scale, tol * scale
    return (lr * ((a + t) / (a + t + eps)
                  - (a - t) / ((a - t).abs() + eps))).float()


# --- plain SGD (baseline / LDA hyper-updates) ---

def sgd_apply(grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor], lr: float
              ) -> Dict[str, torch.Tensor]:
    return {n: (p.to(F32) - lr * grads[n].to(F32)).to(p.dtype)
            for n, p in params.items()}
