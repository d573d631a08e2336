"""LightLDA's Metropolis-Hastings sampler, the serving half (paper section 3).

Collapsed Gibbs sampling for LDA keeps three count statistics -- ``n_k``
(tokens per topic), ``n_wk`` (word w in topic k) and ``n_dk`` (tokens of doc d
in topic k) -- and resamples every token's topic ``z`` from

  P(z=k) ∝ (n_dk^{-dw} + α) · (n_wk^{-dw} + β) / (n_k^{-dw} + Vβ).

LightLDA factorises this into a *doc proposal* ``q_d(k) ∝ n_dk + α`` (drawn
O(1) by picking a random token's current assignment, or the α-branch) and a
*word proposal* ``q_w(k) ∝ (n_wk + β)/(n_k + Vβ)`` (drawn O(1) from a Vose
alias table), with an MH acceptance test after each.

This module holds what serving needs: the config, the pre-drawn randomness
(``MHRandoms``), the chain itself (``mh_chain``, the plain version behind the
hand-written ``mh_sample`` kernel), and the frozen-model entry points
(``freeze_model``, ``sample_tokens_frozen``).  Every floating-point
expression keeps the JAX package's operation order, so the chain is bitwise
equal to it given the same randoms.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import perplexity as ppl


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    num_topics: int
    vocab_size: int
    alpha: float = 0.1            # document-topic Dirichlet prior
    beta: float = 0.01            # topic-word Dirichlet prior
    mh_steps: int = 2             # MH steps per token (LightLDA default)
    block_tokens: int = 8192      # staleness window == paper's push buffer
    num_shards: int = 1           # parameter-server shards

    @property
    def K(self) -> int:
        return self.num_topics

    @property
    def V(self) -> int:
        return self.vocab_size


# ---------------------------------------------------------------------------
# Proposal densities and acceptance ratios (LightLDA eqs., paper eq. 1)
# ---------------------------------------------------------------------------

def _gather_cols(mat_rows: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """mat_rows: [B, K]; k: [B] -> [B] picking column k_i of row i."""
    return mat_rows.gather(1, k.long()[:, None])[:, 0]


def _posterior_terms(k, z0, nwk_w, ndk_d, nk, alpha, beta, vbeta,
                     frozen: bool = False):
    """Collapsed posterior factors p(k) with the -dw correction.

    The counts include the token's assignment ``z0``; excluding the token
    itself means subtracting 1 exactly where ``k == z0``.  ``frozen`` is the
    fold-in mode: the document was never counted into ``n_wk``/``n_k``, so
    the correction applies only to the local ``n_dk``.
    """
    excl = (k == z0).to(torch.float32)
    excl_wk = 0.0 if frozen else excl
    ndk = _gather_cols(ndk_d, k).to(torch.float32) - excl
    nwk = _gather_cols(nwk_w, k).to(torch.float32) - excl_wk
    nk_ = nk[k.long()].to(torch.float32) - excl_wk
    return (ndk + alpha) * (nwk + beta) / (nk_ + vbeta)


def _word_proposal_pmf(k, nwk_w, nk, beta, vbeta):
    """q_w(k) ∝ (n_wk+β)/(n_k+Vβ) with the alias-table counts."""
    nwk = _gather_cols(nwk_w, k).to(torch.float32)
    nk_ = nk[k.long()].to(torch.float32)
    return (nwk + beta) / (nk_ + vbeta)


def _doc_proposal_pmf(k, ndk_d, alpha):
    """q_d(k) ∝ n_dk+α with the counts the draw used."""
    return _gather_cols(ndk_d, k).to(torch.float32) + alpha


# ---------------------------------------------------------------------------
# The vectorised MH chain for a block of tokens (the plain version).
# ---------------------------------------------------------------------------

class MHRandoms(NamedTuple):
    """Pre-drawn randomness for the MH chain, all shaped [mh_steps, B].

    Pre-drawing is exactly equivalent to drawing inside the chain: the word
    proposal consumes one uniform per step, the acceptance tests one coin
    each, and the doc proposal does not depend on the chain state, so it can
    be materialised up front.  This is what lets the CUDA kernel and this
    plain chain share bit-identical semantics.
    """

    u_word: torch.Tensor     # float32 uniforms for the alias draw
    u_waccept: torch.Tensor  # float32 accept coins, word step
    z_doc: torch.Tensor      # int32 pre-drawn doc proposals
    u_daccept: torch.Tensor  # float32 accept coins, doc step


def mh_chain(rng: MHRandoms, z0: torch.Tensor,
             nwk_rows: torch.Tensor, ndk_rows: torch.Tensor, nk: torch.Tensor,
             aprob_rows: torch.Tensor, aalias_rows: torch.Tensor,
             cfg: LDAConfig, frozen: bool = False) -> torch.Tensor:
    """Run ``cfg.mh_steps`` x (word proposal, doc proposal) MH steps for B
    tokens whose count and alias rows are pre-gathered: ``nwk_rows``,
    ``ndk_rows``, ``aprob_rows``, ``aalias_rows`` are [B, K], ``nk`` is [K].
    Returns the new [B] int32 assignments."""
    from repro_torch.core.alias import alias_sample

    alpha, beta = cfg.alpha, cfg.beta
    vbeta = cfg.V * beta

    def p(k):
        # the -dw correction always refers to z0 (what the counts contain)
        return _posterior_terms(k, z0, nwk_rows, ndk_rows, nk, alpha, beta,
                                vbeta, frozen=frozen)

    def qw(k):
        return _word_proposal_pmf(k, nwk_rows, nk, beta, vbeta)

    def qd(k):
        return _doc_proposal_pmf(k, ndk_rows, alpha)

    z = z0
    for s in range(cfg.mh_steps):
        # word proposal (alias table; amortised O(1) per draw)
        z_prop = alias_sample(aprob_rows, aalias_rows, rng.u_word[s])
        ratio = (p(z_prop) * qw(z)) / (
            torch.clamp_min(p(z), 1e-30) * torch.clamp_min(qw(z_prop), 1e-30))
        z = torch.where(rng.u_waccept[s] < ratio, z_prop, z)

        # doc proposal (pre-drawn; independent of the chain state)
        z_prop = rng.z_doc[s]
        ratio = (p(z_prop) * qd(z)) / (
            torch.clamp_min(p(z), 1e-30) * torch.clamp_min(qd(z_prop), 1e-30))
        z = torch.where(rng.u_daccept[s] < ratio, z_prop, z)
    return z


# ---------------------------------------------------------------------------
# Frozen-model sampling (serving / fold-in inference).
#
# A serving snapshot freezes (n_wk, n_k) -- and therefore the word proposal
# q_w -- so the alias tables are built ONCE per snapshot and amortised over
# every request.
# ---------------------------------------------------------------------------

class FrozenModel(NamedTuple):
    """Immutable model snapshot for inference: dense float32 counts plus the
    per-word alias-table rows of q_w(k) ∝ (n_wk+β)/(n_k+Vβ)."""

    nwk: torch.Tensor     # [V, K] float32 word-topic counts
    nk: torch.Tensor      # [K]    float32 topic totals
    aprob: torch.Tensor   # [V, K] float32 alias acceptance probabilities
    aalias: torch.Tensor  # [V, K] int32 alias targets

    def to(self, device) -> "FrozenModel":
        return FrozenModel(*(t.to(device) for t in self))


def freeze_model(nwk_dense: torch.Tensor, nk: torch.Tensor, cfg: LDAConfig,
                 weights: Optional[torch.Tensor] = None) -> FrozenModel:
    """Freeze dense counts into a ``FrozenModel`` (alias tables included).

    The once-per-snapshot O(V*K) step.  ``weights`` lets the caller pass the
    already-computed smoothed φ (q_w and φ are the same quantity).  The
    alias build runs the hand-written ``alias_build`` kernel on a CUDA
    tensor and its plain version on a CPU one (``kernels.ops``).
    """
    from repro_torch.kernels import ops

    nwk_f = nwk_dense.to(torch.float32)
    nk_f = nk.to(torch.float32)
    if weights is None:
        weights = ppl.phi_from_counts(nwk_f, nk_f, cfg.beta)
    table = ops.alias_build(weights)
    return FrozenModel(nwk_f, nk_f, table.prob, table.alias)


def sample_tokens_frozen(model: FrozenModel, rng: MHRandoms, z0: torch.Tensor,
                         w: torch.Tensor, d: torch.Tensor, ndk: torch.Tensor,
                         cfg: LDAConfig) -> torch.Tensor:
    """Resample a flat batch of tokens against a frozen model.

    ``w``/``d``/``z0`` are [T]: each token's word row in the model tables,
    its document's row in ``ndk`` [D, K] (int32 local doc-topic counts), and
    its current topic.  The tables are read in place -- nothing is gathered
    to [T, K] on the card (``kernels.ops.mh_sample``).
    """
    from repro_torch.kernels import ops

    return ops.mh_sample(rng, z0, w, d, model.nwk, ndk, model.nk,
                         model.aprob, model.aalias, cfg, frozen=True)
