"""Batched fold-in inference against a frozen model.

Fold-in estimates θ_d for *unseen* documents by MH-sampling their topic
assignments with the model counts (n_wk, n_k) frozen -- the serving
counterpart of training, and the sampler behind the paper's IR use cases.
Because the word proposal depends only on the frozen counts, the alias
tables are built once per snapshot (``lightlda.freeze_model``) and every
request samples in amortised O(1) per token.  The only difference from
training is the -dw correction: an unseen document's tokens were never
counted into n_wk/n_k, so the exclusion applies to the local n_dk only.

Layout: documents are packed into a dense [B, L] batch (tokens left-packed
per row, right-padded with ``valid=False``).  All randomness comes from a
*per-document* key (``repro_torch.rng``, bitwise jax's threefry stream), and
every operation in a sweep is row-wise, so a document's θ is a pure function
of (snapshot, tokens, its key, L): results are bit-identical however
requests are batched -- and bit-identical to the JAX package's fold-in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import rng as jrng
from repro_torch.core import lightlda as lda
from repro_torch.kernels import ops
from repro_torch.obs import ObsConfig


@dataclasses.dataclass(frozen=True)
class FoldInConfig:
    """Fold-in chain schedule.

    ``num_sweeps`` full passes over each document's tokens; θ is estimated
    from the average n_dk of the post-``burnin`` sweeps (a Rao-Blackwellised
    point estimate).  ``obs`` is the serving-side telemetry tri-state (None:
    inherit the installed session; ``ObsConfig(enabled=False)``: suppress).
    """

    num_sweeps: int = 30
    burnin: int = 10
    obs: Optional[ObsConfig] = None

    def __post_init__(self):
        if not 0 <= self.burnin < self.num_sweeps:
            raise ValueError(f"need 0 <= burnin < num_sweeps, got "
                             f"({self.burnin}, {self.num_sweeps})")


def pack_docs(docs: Sequence[np.ndarray], length: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack token-id lists into the dense [B, L] fold-in layout (left-packed,
    right-padded; docs longer than ``length`` are truncated)."""
    b = len(docs)
    w = np.zeros((b, length), np.int32)
    valid = np.zeros((b, length), bool)
    for i, doc in enumerate(docs):
        n = min(len(doc), length)
        w[i, :n] = np.asarray(doc[:n], np.int32)
        valid[i, :n] = True
    return w, valid


def _doc_randoms(keys: torch.Tensor, z: torch.Tensor, nd: torch.Tensor,
                 cfg: lda.LDAConfig) -> Tuple[torch.Tensor, ...]:
    """Pre-draw one sweep's MH randomness for every document row (the
    plain version of the ``mh_draws_foldin`` kernel, ``kernels.ref``).

    ``keys`` [B, 2], ``z`` [B, L], ``nd`` [B] -> four [B, mh_steps, L]
    arrays.  The doc proposal q_d(k) ∝ n_dk+α is drawn O(1) by picking a
    uniformly random token of the row's left-packed prefix (the n_dk/N_d
    part) or a uniform topic (the α-branch).
    """
    shape = (cfg.mh_steps, z.shape[1])
    sub = jrng.split(keys, 4)
    kw, kwa, kd, kda = (sub[:, i] for i in range(4))
    dsub = jrng.split(kd, 3)
    k1, k2, k3 = (dsub[:, i] for i in range(3))
    ndf = torch.clamp_min(nd.to(torch.float32), 1.0)[:, None, None]
    pos = (jrng.uniform(k1, shape) * ndf).to(torch.int32)
    pos = torch.minimum(pos, torch.clamp_min(nd - 1, 0)[:, None, None])
    z_tok = torch.gather(z, 1, pos.reshape(z.shape[0], -1).long()
                         ).reshape(pos.shape)
    z_unif = jrng.randint(k2, shape, 0, cfg.K)
    nd_f = nd.to(torch.float32)[:, None, None]
    use_tok = jrng.uniform(k3, shape) * (nd_f + cfg.K * cfg.alpha) < nd_f
    z_doc = torch.where(use_tok, z_tok, z_unif)
    return (jrng.uniform(kw, shape), jrng.uniform(kwa, shape), z_doc,
            jrng.uniform(kda, shape))


def _ndk_from_z(z: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] assignments -> [B, K] int32 doc-topic counts of valid tokens."""
    ndk = torch.zeros((z.shape[0], k), dtype=torch.int32, device=z.device)
    return ndk.scatter_add_(1, z.long(), valid.to(torch.int32))


def fold_in_batch(model: lda.FrozenModel, w: torch.Tensor,
                  valid: torch.Tensor, doc_keys: torch.Tensor,
                  cfg: lda.LDAConfig, fcfg: FoldInConfig) -> torch.Tensor:
    """Fold a batch of unseen documents into a frozen model; return θ [B, K].

    ``w``/``valid`` are the [B, L] packed layout of ``pack_docs`` and
    ``doc_keys`` a [B, 2] batch of keys (one per document), all on the
    model's device.  One sweep resamples every token once against the
    sweep-start state: on a card, one launch of the ``mh_draws_foldin``
    kernel (the sweep's randoms) and one of the ``mh_sample`` kernel.
    """
    b, l = w.shape
    dev = w.device
    w_flat = w.reshape(b * l).to(torch.int32)
    d_flat = torch.arange(b, dtype=torch.int32, device=dev
                          ).repeat_interleave(l)
    nd = valid.to(torch.int32).sum(1, dtype=torch.int32)              # [B]

    z = ops.randint(doc_keys, (l,), 0, cfg.K, fold_in=(0x1d4,))
    ndk_acc = torch.zeros((b, cfg.K), dtype=torch.int32, device=dev)
    for s in range(fcfg.num_sweeps):
        # _doc_randoms(fold_in(doc_keys, s), z, nd) as [S, B*L]
        rng = ops.mh_draws_foldin(doc_keys, s, z, nd, cfg)
        ndk = _ndk_from_z(z, valid, cfg.K)
        z_new = lda.sample_tokens_frozen(model, rng, z.reshape(b * l),
                                         w_flat, d_flat, ndk, cfg)
        z = torch.where(valid, z_new.reshape(b, l), z)
        if s >= fcfg.burnin:
            ndk_acc += _ndk_from_z(z, valid, cfg.K)
    # θ as the JAX package computes it: XLA rewrites the division by the
    # constant sample count as a product with its fp32 reciprocal and fuses
    # that product with "+ α" into one multiply-add, rounded once.  In
    # float64 the product and the sum are exact for these counts (integer
    # sums below 2^24 times a 24-bit reciprocal, plus a 24-bit α), so one
    # rounding to fp32 gives the fused result on any device.
    samples = torch.tensor(float(fcfg.num_sweeps - fcfg.burnin), device=dev)
    inv = (1.0 / samples).to(torch.float64)
    alpha = torch.tensor(cfg.alpha, dtype=torch.float32, device=dev)
    num = (ndk_acc.to(torch.float64) * inv + alpha.to(torch.float64))
    # divide by tensors only: a CUDA tensor divided by a Python scalar is
    # computed as a product with the reciprocal
    return (num.to(torch.float32)
            / (nd.to(torch.float32)[:, None] + cfg.K * cfg.alpha))


def fold_in_docs(model: lda.FrozenModel, docs: Sequence[np.ndarray],
                 cfg: lda.LDAConfig, fcfg: FoldInConfig,
                 seeds: Optional[Sequence[int]] = None,
                 length: Optional[int] = None) -> np.ndarray:
    """One-shot fold-in for a list of docs on the model's device (no
    batching policy; the query engine adds padding-bucket batching)."""
    if length is None:
        length = max((len(d) for d in docs), default=1) or 1
    w, valid = pack_docs(docs, length)
    if seeds is None:
        seeds = range(len(docs))
    dev = model.nwk.device
    theta = fold_in_batch(model, torch.from_numpy(w).to(dev),
                          torch.from_numpy(valid).to(dev),
                          jrng.keys_from_seeds(seeds, dev), cfg, fcfg)
    return theta.cpu().numpy()
