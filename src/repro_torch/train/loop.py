"""LM training loop: state, the train step, the host loop; the twin of the
JAX package's ``train/loop.py`` on one device.

``make_train_step`` returns loss -> gradients -> clip -> AdamW as one eager
function: the model's forward and autograd's backward, then
``optimizer.apply`` in place.  ``jit_train_step`` returns that same step
(no ``torch.compile``, no CUDA graph: this is the eager baseline).  On a
mesh the JAX package shards parameters, moments and the batch
(``state_specs``); that half is ROADMAP A.8.3.

With ``tc.microbatch > 1`` the batch is split into microbatches run one
after another, each one's gradient (in the parameter's dtype) widened to
float32, divided by the microbatch count and added to a float32
accumulator, as the reference's scan does.  The gradients are folded in as
autograd finishes each parameter's (a post-accumulate-grad hook, then
``grad = None``), so the bf16 gradients of all the leaves never coexist,
and ``.grad`` never accumulates across microbatches (which would add them
in bf16).

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


def init_state(seed, cfg: ModelConfig, ctx: MeshCtx = SINGLE,
               device: Device = None) -> TrainState:
    """Weights drawn from ``seed`` (``transformer.init_params``) on the card
    unless ``device`` says otherwise, zero moments."""
    model = tfm.init_params(seed, cfg, ctx, device)
    return TrainState(model, opt.init(dict(model.named_parameters())))


def state_specs(state: TrainState, ctx: MeshCtx = SINGLE) -> dict:
    """Every parameter and moment replicated (``()``, the reference's
    ``P()``): on one device nothing is sharded (training on a mesh is
    ROADMAP A.8.3's training half)."""
    ps = {n: () for n in state.params}
    return {"params": ps, "opt": opt.AdamWState(ps, dict(ps), ())}


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


def make_train_step(cfg: ModelConfig, tc: TrainConfig, ctx: MeshCtx = SINGLE
                    ) -> Callable:
    """Returns ``train_step(state, tokens, targets, mask, cond=None) ->
    (state, metrics)``; the parameters and moments are updated in place and
    the metrics are 0-d tensors (``loss``, ``xent``, ``aux``, ``lr``,
    ``grad_norm``) left on the device.  One device only: a mesh (the
    sharded moments, gradients through the all-to-all) is ROADMAP A.8.3's
    training half."""
    if ctx.mesh is not None:
        raise NotImplementedError(
            "a train step on a device mesh is ROADMAP A.8.3's training "
            "half, not ported yet; the port serves on a mesh and trains on "
            "one device")
    mb = max(tc.microbatch, 1)

    def train_step(state: TrainState, tokens, targets, mask, cond=None):
        params = state.params
        for p in params.values():
            p.grad = None
        if mb == 1:
            loss, metrics = tfm.loss_fn(state.model, tokens, targets, mask,
                                        cond)
            loss.backward()
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in params.items()}
        else:
            b = tokens.shape[0]
            if b % mb:
                raise ValueError(f"batch {b} does not split into {mb} "
                                 "microbatches")
            n = b // mb
            grads = {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                     for k, p in params.items()}
            hooks = [p.register_post_accumulate_grad_hook(
                _fold_into(grads[k], mb)) for k, p in params.items()]
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
            metrics = {k: torch.stack([r[k] for r in runs]).mean()
                       for k in runs[0]}
            loss = metrics.pop("loss")
        _, new_opt, om = opt.apply(grads, state.opt, params, tc)
        for p in params.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **om)
        return TrainState(state.model, new_opt), metrics

    return train_step


def jit_train_step(cfg: ModelConfig, tc: TrainConfig, ctx: MeshCtx,
                   state: TrainState, donate: bool = True) -> Callable:
    """The reference compiles the step with shardings; the port runs it
    eagerly on one device (``state`` and ``donate`` are the reference's
    arguments: the step updates the state in place anyway)."""
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
    read back (which waits for the device) into the history."""
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
