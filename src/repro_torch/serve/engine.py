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
KV leaf where KV heads tile the model axis, the whole latent for MLA,
its SSM heads' state: ``transformer.cache_shapes``), gathers the physical
logits row over the model group before sampling, and returns the whole
batch's tokens (all-gathered over the data axis).  A batch smaller than
the data axis (the reference's condition, long_500k) is **sequence-
sharded** instead: every data rank takes the whole batch, holds its block
of ``ceil(max_seq / dp)`` slots of each attention and MLA cache (a
``max_seq`` that does not split is padded, as a ``NamedSharding`` pads;
the padding slots are never live), and each decode step combines the
ranks' partial softmax statistics (``layers.lse_combine``), so every data
rank computes the same tokens and returns them without a gather.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

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
        # the request ``generate`` serves: this rank's rows, the batch size
        self._rows, self._batch = slice(None), None

    def seq_sharded(self, batch: int) -> bool:
        """Whether a ``batch``-row request is served with the caches
        sequence-sharded: on a mesh, a batch smaller than the data axis
        (the reference's ``cache_specs`` condition)."""
        return self.comm is not None and batch < self.comm.data

    def local_batch(self, batch: int) -> slice:
        """This rank's rows of a ``batch``-row request: its data slice, or
        the whole batch where it is sequence-sharded."""
        if self.comm is None or self.seq_sharded(batch):
            return slice(None)
        dp = self.comm.data
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
            rows = self._batch or logits_phys.shape[0]
            noise = rng.gumbel(key.to(logits_phys.device),
                               (rows,) + tuple(logits_phys.shape[1:])
                               )[self._rows]
            phys = torch.argmax(noise + logits_phys.to(torch.float32)
                                / self.scfg.temperature, dim=-1)
        if self.layout.mode == "blocked":
            return phys.to(torch.int32)
        return self.layout.cyclic.to_logical(phys).to(torch.int32)

    def prefill(self, prompts: torch.Tensor,
                cond: Optional[torch.Tensor] = None, seq_shard: bool = False):
        """Allocate the ``max_seq`` cache and run the prompt through it.
        Returns ``(last-position logits [B, Vpad], caches)`` (on a mesh:
        ``prompts`` and ``cond`` are this rank's rows, the logits their
        whole physical rows; ``seq_shard``: the caches are sequence-sharded,
        which they record for ``step``)."""
        caches = tfm.allocate_cache(self.cfg, prompts.shape[0],
                                    self.scfg.max_seq, self.model.device,
                                    self.ctx, seq_shard)
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
                 cond: Optional[torch.Tensor] = None,
                 mark: Optional[Callable[[str], None]] = None
                 ) -> torch.Tensor:
        """prompts: [B, S_prompt] int.  Returns [B, num_tokens] int32 (on a
        mesh every rank passes the whole batch and gets it back).
        ``mark``, if given, is called with ``"prefill"`` once the prefill
        and its token are done and with ``"step"`` after each decode step
        and its token (``serve.mesh_worker`` times the parts with it)."""
        b, sp = prompts.shape
        if sp + num_tokens > self.scfg.max_seq:
            raise ValueError(f"prompt {sp} + {num_tokens} tokens exceed "
                             f"max_seq {self.scfg.max_seq}")
        rows = self.local_batch(b)
        self._rows, self._batch = rows, b
        prompts = prompts[rows]
        cond = None if cond is None else cond[rows]
        key = rng.PRNGKey(self.scfg.seed)
        logits, caches = self.prefill(prompts, cond, self.seq_sharded(b))
        out = []
        key, sub = rng.split(key)
        tok = self.sample(logits, sub)
        if mark is not None:
            mark("prefill")
        for i in range(num_tokens):
            out.append(tok)
            if i + 1 == num_tokens:
                break
            logits = self.step(tok, caches, sp + i, cond)
            key, sub = rng.split(key)
            tok = self.sample(logits, sub)
            if mark is not None:
                mark("step")
        out = torch.stack(out, dim=1)
        if out.shape[0] < b:             # this rank's data slice
            out = self.comm.all_gather(out, "data", tag="tokens")
        return out
