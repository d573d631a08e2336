"""Batched LM serving engine: prefill + decode with a preallocated cache.

The twin of the JAX package's ``serve/engine.py``.  The cache is allocated
once at ``max_seq`` slots (``registry.cache_shapes``), prefill writes the
prompt's K/V and SSM state into it, and each decode step writes one slot in
place (the reference jits the step with the cache donated, which is the
same thing).  Sampling: greedy, or temperature through the reference's key
schedule (``PRNGKey(seed)``, one split a token) and ``categorical``'s
Gumbel-max form.

**On a mesh** (the model's ``ctx`` over a rank's ``launch.mesh.Mesh``)
every rank runs the same ``generate`` on the whole batch of prompts: it
takes its data slice of the batch, holds its cache (1/``model`` of each
KV leaf where KV heads tile the model axis, the whole latent for MLA:
``transformer.cache_shapes``), gathers the physical logits row over the
model group before sampling, and returns the whole batch's tokens
(all-gathered over the data axis).  A batch smaller than the data axis
would need the sequence-sharded cache of ``specs.cache_specs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import gather_vocab


@dataclasses.dataclass
class ServeConfig:
    max_seq: int
    temperature: float = 0.0     # 0 => greedy
    seed: int = 0


class Engine:
    def __init__(self, model: tfm.Transformer, scfg: ServeConfig):
        self.model = model
        self.cfg = model.cfg
        self.scfg = scfg
        self.ctx = model.ctx
        self.comm = self.ctx.comm
        self.layout = model.layout
        self._valid = self.layout.valid_columns(model.device)
        self._rows = slice(None)          # this rank's rows of the batch

    def local_batch(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row request: its data slice."""
        if self.comm is None:
            return slice(None)
        dp = self.comm.data
        if batch < dp:
            raise NotImplementedError(
                f"a batch of {batch} on {dp} data ranks needs the "
                "sequence-sharded cache (specs.cache_specs), ROADMAP A.8.3")
        if batch % dp:
            raise ValueError(f"batch {batch} does not split over {dp} data "
                             "ranks")
        n = batch // dp
        return slice(self.comm.data_idx * n, (self.comm.data_idx + 1) * n)

    def sample(self, logits_phys: torch.Tensor, key: torch.Tensor
               ) -> torch.Tensor:
        """Sample in physical vocab order, return *logical* token ids
        (int32).  ``key`` is a host key (``rng.PRNGKey`` layout).  With a
        temperature the noise is ``jax.random.categorical``'s: argmax of
        logits/T plus float32 Gumbel noise drawn from ``key`` (the
        reference draws it in the logits' dtype, so a bf16 model's samples
        differ from it there)."""
        if self._valid is not None:
            logits_phys = torch.where(self._valid, logits_phys, -math.inf)
        if self.scfg.temperature <= 0.0:
            phys = torch.argmax(logits_phys, dim=-1)
        else:
            # the whole batch's noise, this rank's rows of it
            rows = logits_phys.shape[0]
            if self.comm is not None:
                rows *= self.comm.data
            noise = rng.gumbel(key.to(logits_phys.device),
                               (rows,) + tuple(logits_phys.shape[1:])
                               )[self._rows]
            phys = torch.argmax(noise + logits_phys.to(torch.float32)
                                / self.scfg.temperature, dim=-1)
        if self.layout.mode == "blocked":
            return phys.to(torch.int32)
        return self.layout.cyclic.to_logical(phys).to(torch.int32)

    def prefill(self, prompts: torch.Tensor,
                cond: Optional[torch.Tensor] = None):
        """Allocate the ``max_seq`` cache and run the prompt through it.
        Returns ``(last-position logits [B, Vpad], caches)`` (on a mesh:
        ``prompts`` and ``cond`` are this rank's rows, the logits their
        whole physical rows)."""
        caches = tfm.allocate_cache(self.cfg, prompts.shape[0],
                                    self.scfg.max_seq, self.model.device,
                                    self.ctx)
        with torch.no_grad():
            logits, caches = tfm.prefill(self.model, prompts, cond, caches)
        return gather_vocab(logits, self.ctx), caches

    def step(self, token: torch.Tensor, caches: dict, pos: int,
             cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step at ``pos``: logits [B, Vpad]; caches in place."""
        with torch.no_grad():
            return gather_vocab(self.model.decode_step(token, caches, pos,
                                                       cond), self.ctx)

    def generate(self, prompts: torch.Tensor, num_tokens: int,
                 cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """prompts: [B, S_prompt] int.  Returns [B, num_tokens] int32 (on a
        mesh every rank passes the whole batch and gets it back)."""
        b, sp = prompts.shape
        if sp + num_tokens > self.scfg.max_seq:
            raise ValueError(f"prompt {sp} + {num_tokens} tokens exceed "
                             f"max_seq {self.scfg.max_seq}")
        self._rows = rows = self.local_batch(b)
        prompts = prompts[rows]
        cond = None if cond is None else cond[rows]
        key = rng.PRNGKey(self.scfg.seed)
        logits, caches = self.prefill(prompts, cond)
        out = []
        key, sub = rng.split(key)
        tok = self.sample(logits, sub)
        for i in range(num_tokens):
            out.append(tok)
            if i + 1 == num_tokens:
                break
            logits = self.step(tok, caches, sp + i, cond)
            key, sub = rng.split(key)
            tok = self.sample(logits, sub)
        out = torch.stack(out, dim=1)
        if self.comm is not None and self.comm.data > 1:
            out = self.comm.all_gather(out, "data", tag="tokens")
        return out
