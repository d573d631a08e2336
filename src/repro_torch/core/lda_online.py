"""Baseline 2: Online variational Bayes LDA (Hoffman et al., 2010) -- the
analogue of Spark MLlib's ``OnlineLDAOptimizer`` (paper section 4,
"Spark Online", paper ref [5]), in PyTorch.

Global variational parameter λ [K, V] over topic-word distributions; per
minibatch of documents:

  E-step (per doc, fixed-point):   φ_dwk ∝ exp(E[log θ_dk]) exp(E[log β_kw])
                                   γ_dk  = α + Σ_w n_dw φ_dwk
  M-step (stochastic natural grad): λ ← (1-ρ_t) λ + ρ_t (η + (D/|B|) Σ_d n_dw φ_dwk)
  with learning rate ρ_t = (τ0 + t)^{-κ}.

MLlib keeps λ in its coordinating process and broadcasts it every batch
-- the paper's Table 1 shows this scales poorly with K.  The parameter
server removes that bottleneck; ``chip_smoke.py`` reproduces the
comparison.

The products are float32 ``torch.matmul`` calls (the JAX package computes
them with XLA, outside any Pallas kernel); nothing here enables TF32, so on
the card they stay float32, as the CPU reference is.  ρ_t and the
``D/|B|`` scale are float32 tensors, as the JAX package computes them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.device import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    num_topics: int
    vocab_size: int
    alpha: float = 0.1           # doc-topic prior
    eta: float = 0.01            # topic-word prior
    tau0: float = 64.0
    kappa: float = 0.75
    batch_docs: int = 64
    e_iters: int = 25

    @property
    def K(self):
        return self.num_topics

    @property
    def V(self):
        return self.vocab_size


class OnlineState(NamedTuple):
    lam: torch.Tensor   # [K, V] global variational parameter
    t: torch.Tensor     # scalar int32 step counter


def standard_gamma(shape, a: float, gen: torch.Generator,
                   device: torch.device) -> torch.Tensor:
    """Gamma(a, 1) float32 draws for ``a >= 1`` by Marsaglia and Tsang's
    squeeze-free rejection method, from ``gen`` alone: a normal and a
    uniform per candidate, the rejected entries drawn again until none is
    left."""
    dd = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * dd)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    flat = out.view(-1)
    todo = torch.arange(flat.numel(), device=device)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=gen, device=device)
        u = torch.rand(todo.numel(), generator=gen, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v
                        + dd * torch.log(v))
        flat[todo[ok]] = dd * v[ok]
        todo = todo[~ok]
    return out


def init_state(seed: int, cfg: OnlineConfig,
               device: Device = None) -> OnlineState:
    """λ drawn from Gamma(100) × 0.01 (mean 1, s.d. 0.1), on the card
    unless the caller passes another device.  The draws come from a
    ``torch.Generator`` on that device seeded with ``seed``
    (``standard_gamma``), so the card and the CPU draw different states;
    the JAX package's ``jax.random.gamma`` is a third.  Runs that must
    agree start from a carried λ (``convert.online_state_from_arrays``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    lam = standard_gamma((cfg.K, cfg.V), 100.0, gen, dev) * 0.01
    return OnlineState(lam, torch.zeros((), dtype=torch.int32, device=dev))


def _e_log_beta(lam):
    return torch.digamma(lam) - torch.digamma(lam.sum(-1, keepdim=True))


def _e_log_theta(gamma):
    return torch.digamma(gamma) - torch.digamma(gamma.sum(-1, keepdim=True))


def online_step(state: OnlineState, doc_word: torch.Tensor,
                doc_mask: torch.Tensor, total_docs: int,
                cfg: OnlineConfig) -> OnlineState:
    """One minibatch update.  ``doc_word``: [B, V] dense doc-term counts
    (the data pipeline densifies the minibatch); ``doc_mask``: [B]
    validity.
    """
    exp_elog_beta = torch.exp(_e_log_beta(state.lam))       # [K, V]
    mask = doc_mask.to(torch.float32)

    gamma = torch.ones((doc_word.shape[0], cfg.K), dtype=torch.float32,
                       device=doc_word.device)
    for _ in range(cfg.e_iters):
        exp_elog_theta = torch.exp(_e_log_theta(gamma))      # [B, K]
        # normaliser per (doc, word): Σ_k exp_elog_theta exp_elog_beta
        norm = exp_elog_theta @ exp_elog_beta + 1e-30         # [B, V]
        gamma = cfg.alpha + exp_elog_theta * (
            (doc_word / norm) @ exp_elog_beta.T)

    # sufficient statistics for λ
    exp_elog_theta = torch.exp(_e_log_theta(gamma)) * mask[:, None]
    norm = exp_elog_theta @ exp_elog_beta + 1e-30
    sstats = exp_elog_theta.T @ (doc_word / norm) * exp_elog_beta  # [K, V]

    rho = (cfg.tau0 + state.t.to(torch.float32)) ** (-cfg.kappa)
    scale = (torch.tensor(float(total_docs), device=mask.device)
             / torch.clamp_min(mask.sum(), 1.0))
    lam_new = (1 - rho) * state.lam + rho * (cfg.eta + scale * sstats)
    return OnlineState(lam_new, state.t + 1)


def phi_from_state(state: OnlineState) -> torch.Tensor:
    """Point estimate of topic-word distributions, [V, K] (to match the
    perplexity module's convention), stored row-major for the row
    gathers of ``perplexity.fold_in_theta``."""
    lam = state.lam
    return (lam / lam.sum(-1, keepdim=True)).T.contiguous()


def train(state: OnlineState, doc_word_batches, doc_mask_batches,
          total_docs: int, cfg: OnlineConfig) -> OnlineState:
    for dw, dm in zip(doc_word_batches, doc_mask_batches):
        state = online_step(state, dw, dm, total_docs, cfg)
    return state
