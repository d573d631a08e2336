"""LM training loop: state, the train step, the host loop; the twin of the
JAX package's ``train/loop.py``.

``make_train_step`` returns loss -> gradients -> clip -> AdamW as one eager
function: the model's forward and autograd's backward, then
``optimizer.apply`` in place.  ``jit_train_step`` returns that same step
(no ``torch.compile``, no CUDA graph: this is the eager baseline).

With ``tc.microbatch > 1`` the batch is split into microbatches run one
after another, each one's gradient (in the parameter's dtype) widened to
float32, divided by the microbatch count and added to a float32
accumulator, as the reference's scan does.  On one device the gradients
are folded in as autograd finishes each parameter's (a post-accumulate-
grad hook, then ``grad = None``), so the bf16 gradients of all the leaves
never coexist, and ``.grad`` never accumulates across microbatches (which
would add them in bf16).

**On a mesh** (a ``MeshCtx`` over a rank's ``launch.mesh.Mesh``; every
rank runs the same step on the same global batch) the model holds the
rank's parameter blocks and the moments their ZeRO blocks
(``state_specs``: the reference's ``param_specs`` and
``opt_state_specs``; ``optimizer.Zero``).  The global batch is split into
microbatches first and each microbatch's rows over the data axis (the
reference's order, so each microbatch's metrics are the single device's).
The model's collectives carry their gradients (``models.layers``), the
loss is the whole microbatch's, and after each microbatch's backward the
gradients are widened to float32 and reduce-scattered over the data axis,
leaf by leaf in ``named_parameters`` order -- one order on every rank --
before the float32 add.  The step gives the single device's loss,
gradients and update on the same logical weights.

``fit_lda`` / ``fit_lda_stream`` are **deprecated shims**, kept as the
reference keeps them: the unified LDA trainer lives in
``repro_torch.api.session``.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import Device
from repro_torch.models import transformer as tfm
from repro_torch.obs import marks
from repro_torch.sharding import specs
from repro_torch.sharding.specs import SINGLE, MeshCtx
from repro_torch.train import optimizer as opt

F32 = torch.float32


class TrainState(NamedTuple):
    """The model (its parameters) and the AdamW state over them."""

    model: tfm.Transformer
    opt: opt.AdamWState

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.model.named_parameters())


def zero_of(model: tfm.Transformer) -> Optional[opt.Zero]:
    """The model's ZeRO plan on a mesh of ranks (None on one device)."""
    return opt.Zero(model, model.ctx) if model.ctx.comm is not None \
        else None


def init_state(seed, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
               device: Device = None) -> TrainState:
    """Weights drawn from ``seed`` (``transformer.init_params``) on the card
    unless ``device`` says otherwise, zero moments (on a mesh the rank's
    blocks of the single-device weights of ``seed``, and ZeRO moments)."""
    model = tfm.init_params(seed, cfg, ctx, device)
    return TrainState(model, opt.init(dict(model.named_parameters()),
                                      zero_of(model)))


def state_specs(state: TrainState, ctx: MeshCtx = SINGLE) -> dict:
    """The reference's ``TrainState(param_specs, AdamWState(opt_specs,
    opt_specs, P()))`` keyed by parameter name: the parameters as the
    rules split them, the moments ZeRO-split over the dp axes as well
    (``specs.opt_state_specs``); everything ``P()`` on one device."""
    names = list(state.params)
    if ctx.mesh is None:
        ps = {n: specs.P() for n in names}
        os_ = dict(ps)
    else:
        pt = specs.param_specs(state.model, ctx)
        ot = specs.opt_state_specs(state.model, ctx)
        ps = {n: pt[specs.path_str(n)] for n in names}
        os_ = {n: ot[specs.path_str(n)] for n in names}
    return {"params": ps, "opt": opt.AdamWState(os_, dict(os_), specs.P())}


def _fold_into(acc: torch.Tensor, mb: int) -> Callable:
    """A post-accumulate-grad hook: ``acc += grad.float() / mb`` (a slice of
    rows at a time), then drop the gradient."""
    def hook(p: torch.Tensor) -> None:
        g = p.grad
        with torch.no_grad():
            for sl in opt.row_slices(acc):
                acc[sl].add_(g[sl].to(F32) / mb)
        p.grad = None
    return hook


def step_grads(state: TrainState, mb: int, tokens, targets, mask,
               cond=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A train step's first half: the gradient it applies and its
    metrics.  On one device the microbatches' gradients summed in float32
    (with ``mb == 1`` the one gradient, in the parameters' dtype); on a
    mesh the rank's ZeRO slices of that sum (``mesh_grads``).  The
    metrics are the microbatches' means, 0-d tensors."""
    if state.model.ctx.comm is not None:
        return mesh_grads(state, mb, tokens, targets, mask, cond)
    params = state.params
    for p in params.values():
        p.grad = None
    if mb == 1:
        loss, metrics = tfm.loss_fn(state.model, tokens, targets, mask, cond)
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        return grads, {k: v.detach() for k, v in
                       dict(metrics, loss=loss).items()}
    b = tokens.shape[0]
    if b % mb:
        raise ValueError(f"batch {b} does not split into {mb} microbatches")
    n = b // mb
    grads = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
             for k, p in params.items()}
    hooks = [p.register_post_accumulate_grad_hook(_fold_into(grads[k], mb))
             for k, p in params.items()]
    runs = []
    try:
        for i in range(mb):
            part = slice(i * n, (i + 1) * n)
            loss_i, met_i = tfm.loss_fn(
                state.model, tokens[part], targets[part], mask[part],
                None if cond is None else cond[part])
            loss_i.backward()
            runs.append({k: v.detach() for k, v in
                         dict(met_i, loss=loss_i).items()})
    finally:
        for h in hooks:
            h.remove()
    return grads, {k: torch.stack([r[k] for r in runs]).mean()
                   for k in runs[0]}


def mesh_grads(state: TrainState, mb: int, tokens, targets, mask,
               cond=None) -> Tuple[Dict[str, torch.Tensor], dict]:
    """A mesh rank's part of the gradient of the global batch: for each
    of ``mb`` microbatches its data slice's forward and backward, then
    every gradient widened to float32, summed over the data axis onto the
    rank's ZeRO slice (``optimizer.Zero.reduce``, leaf by leaf in
    ``named_parameters`` order), divided by ``mb`` and added to a float32
    accumulator.  Returns ``(accumulator, metrics)``: the ZeRO slices of
    the single device's accumulated gradient, and the microbatches' mean
    metrics (0-d tensors, the same on every rank)."""
    model = state.model
    zero = zero_of(model)
    comm = zero.comm
    b = tokens.shape[0]
    if b % mb or (b // mb) % comm.data:
        raise ValueError(f"batch {b} does not split into {mb} microbatches "
                         f"of rows over {comm.data} data ranks")
    n = b // mb
    per = n // comm.data
    params = state.params
    acc: Dict[str, torch.Tensor] = {}
    runs = []
    for i in range(mb):
        part = slice(i * n + comm.data_idx * per,
                     i * n + (comm.data_idx + 1) * per)
        for p in params.values():
            p.grad = None
        loss_i, met_i = tfm.loss_fn(model, tokens[part], targets[part],
                                    mask[part],
                                    None if cond is None else cond[part])
        loss_i.backward()
        for k, p in params.items():
            g = zero.reduce(k, torch.zeros_like(p) if p.grad is None
                            else p.grad)
            p.grad = None
            g = g / mb if mb > 1 else g
            acc[k] = g if k not in acc else acc[k].add_(g)
        runs.append({k: v.detach() for k, v in
                     dict(met_i, loss=loss_i).items()})
    metrics = {k: torch.stack([r[k] for r in runs]).mean() for k in runs[0]}
    return acc, metrics


def apply_grads(state: TrainState, grads: Dict[str, torch.Tensor],
                tc: TrainConfig) -> Tuple[TrainState, dict]:
    """A train step's second half: AdamW (``optimizer.apply``, on a mesh
    with the rank's ``Zero``) on ``step_grads``'s gradient, in place.
    Returns the state and the optimizer's metrics (``lr``,
    ``grad_norm``)."""
    params = state.params
    zero = zero_of(state.model)     # one device: the reference's 4 arguments
    with marks.span("lm.optimizer"):
        _, new_opt, om = opt.apply(grads, state.opt, params, tc,
                                   *(() if zero is None else (zero,)))
    for p in params.values():
        p.grad = None
    return TrainState(state.model, new_opt), om


def make_train_step(cfg: ModelConfig, tc: TrainConfig, ctx: MeshCtx = SINGLE
                    ) -> Callable:
    """Returns ``train_step(state, tokens, targets, mask, cond=None) ->
    (state, metrics)``: ``step_grads`` then ``apply_grads``.  The
    parameters and moments are updated in place and the metrics are 0-d
    tensors (``loss``, ``xent``, ``aux``, ``lr``, ``grad_norm``) left on
    the device.  On a mesh every rank calls it with the whole batch and
    takes its rows (``mesh_grads``); the metrics are the same on every
    rank.  With an obs session installed the step marks its spans and
    counters on the device (``obs.marks``: ``lm.step.device`` and the
    parts inside it)."""
    mb = max(tc.microbatch, 1)

    def train_step(state: TrainState, tokens, targets, mask, cond=None):
        with marks.step(state.model.device):
            grads, metrics = step_grads(state, mb, tokens, targets, mask,
                                        cond)
            state, om = apply_grads(state, grads, tc)
            del grads
        loss = metrics.pop("loss")
        return state, dict(metrics, loss=loss, **om)

    return train_step


def jit_train_step(cfg: ModelConfig, tc: TrainConfig, ctx: MeshCtx,
                   state: TrainState, donate: bool = True) -> Callable:
    """The reference compiles the step with shardings; the port runs it
    eagerly, on one device or as one rank of a mesh (``state`` and
    ``donate`` are the reference's arguments: the step updates the state
    in place anyway)."""
    return make_train_step(cfg, tc, ctx)


def fit_lda(state, key, cfg, exec_cfg, sweeps: int, eval_every: int = 10,
            log_fn=print):
    """DEPRECATED -- use ``repro_torch.api`` (``APSLDA(job).fit()`` or
    ``Session``); kept as a shim, as the reference keeps it.  Delegates to
    ``api.session.memory_fit``; returns ``(state, history, info)``."""
    warnings.warn(
        "train.loop.fit_lda is deprecated: build a repro_torch.api.LDAJob "
        "and use APSLDA(job).fit() (or repro_torch.api.Session)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import session as api_session

    return api_session.memory_fit(state, key, cfg, exec_cfg, sweeps,
                                  eval_every=eval_every, log_fn=log_fn)


# The stream trainer's RNG helpers, re-exported under the names the
# reference's callers use.
from repro_torch.api.session import (init_stream, stream_init_key,  # noqa: E402
                                     stream_sweep_key)


def fit_lda_stream(reader, cfg, exec_cfg, epochs: int, *, seed: int = 0,
                   checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 0, resume: bool = False,
                   max_shards: Optional[int] = None, eval_every: int = 0,
                   prefetch: bool = True, log_fn=print,
                   device: Device = None):
    """DEPRECATED -- use ``repro_torch.api`` (``LDAJob(stream_dir=...)``
    with a ``CheckpointPolicy``); kept as a shim, as the reference keeps
    it.  Delegates to ``api.session.stream_fit`` on ``device`` (the card
    unless the caller passes another); returns ``(nwk, nk, history,
    info)``."""
    warnings.warn(
        "train.loop.fit_lda_stream is deprecated: build a repro_torch.api."
        "LDAJob(stream_dir=...) and use APSLDA(job).fit() (or "
        "repro_torch.api.Session)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api import session as api_session

    return api_session.stream_fit(
        reader, cfg, exec_cfg, epochs, seed=seed,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        resume=resume, max_shards=max_shards, eval_every=eval_every,
        prefetch=prefetch, log_fn=log_fn, device=device)


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def fit(state: TrainState, batches, cfg: ModelConfig, tc: TrainConfig,
        ctx: MeshCtx = SINGLE, log_every: int = 10, log_fn=print
        ) -> Tuple[TrainState, list]:
    """Simple host loop over an iterable of batches (dicts of numpy arrays,
    moved to the model's device); every ``log_every`` steps the metrics are
    read back (which waits for the device) into the history.  On a mesh
    every rank runs it on the same batches."""
    step_fn = jit_train_step(cfg, tc, ctx, state)
    device = state.model.device
    history = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        b = _to_device(batch, device)
        args = (b["tokens"], b["targets"], b["mask"])
        if cfg.cross_attn_mode:
            args = args + (b["cond"],)
        state, metrics = step_fn(state, *args)
        if i % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = i
            m["elapsed_s"] = time.time() - t0
            history.append(m)
            log_fn(f"step {i:5d} loss {m['loss']:.4f} "
                   f"grad_norm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
    return state, history
