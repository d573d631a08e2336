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
"""
from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig

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


def init(params: Dict[str, torch.Tensor]) -> AdamWState:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=F32, device=p.device)
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


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32 (a slice of rows
    at a time, so a bf16 leaf is never widened whole)."""
    sq = None
    for x in tree.values():
        for sl in row_slices(x):
            c = x[sl].to(F32)
            s = torch.sum(c * c)
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
          params: Dict[str, torch.Tensor], tc: TrainConfig
          ) -> Tuple[Dict[str, torch.Tensor], AdamWState, dict]:
    """One AdamW step, in place: ``params`` and the moments are updated and
    returned with the new step count.  Weight decay applies only to >=2-D
    leaves (matrices/embeddings), not to norms/scalars/biases.  ``grads``
    are read, never written; the clip multiplies in each gradient's own
    dtype, as the reference's ``clip_by_global_norm`` does."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, tc)
    b1, b2 = tc.beta1, tc.beta2
    c1 = 1.0 - torch.pow(b1, step.to(F32))
    c2 = 1.0 - torch.pow(b2, step.to(F32))

    for name, p in params.items():
        g, m, v = grads[name], state.m[name], state.v[name]
        sg = scale.to(g.dtype)
        for sl in row_slices(p):
            g32 = (g[sl] * sg).to(F32)
            mi, vi = m[sl], v[sl]
            mi.mul_(b1).add_(g32 * (1 - b1))       # b1 m + (1 - b1) g
            vi.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            delta = (mi / c1).div_((vi / c2).sqrt_().add_(tc.eps))
            p32 = p[sl].to(F32)
            if p.dim() >= 2:
                delta.add_(p32 * tc.weight_decay)
            p[sl].copy_(p32 - delta.mul_(lr))
    return params, AdamWState(state.m, state.v, step), \
        {"lr": lr, "grad_norm": gn}


# --- plain SGD (baseline / LDA hyper-updates) ---

def sgd_apply(grads: Dict[str, torch.Tensor],
              params: Dict[str, torch.Tensor], lr: float
              ) -> Dict[str, torch.Tensor]:
    return {n: (p.to(F32) - lr * grads[n].to(F32)).to(p.dtype)
            for n, p in params.items()}
