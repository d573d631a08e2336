"""Baseline 1: (variational) EM LDA -- the analogue of Spark MLlib's
``EMLDAOptimizer`` (paper section 4, "Spark EM"), in PyTorch.

MLlib's EM optimizer follows Asuncion et al. (2009) [paper ref 2]: keep
*expected* count tables, and alternate

  E-step:  γ_ik ∝ (n_{d_i k} + α) · (n_{w_i k} + β) / (n_k + Vβ)
  M-step:  n_dk = Σ_{i: d_i=d} γ_ik,   n_wk = Σ_{i: w_i=w} γ_ik,  n_k = Σ_w n_wk

over token-level responsibilities γ.  In Spark this is a GraphX message-
passing job whose per-iteration *shuffle* materialises the γ messages --
that shuffle is exactly the "Shuffle write (GB)" column of paper Table 1
that the parameter-server architecture eliminates.  Here the same algorithm
is two segment sums (``index_add_``); ``shuffle_bytes_per_iter`` reports
the bytes that a map-reduce realisation would shuffle.

The E-step runs over tokens ``_CHUNK_ELEMS`` elements at a time: each
token reads the old ``n_dk``/``n_wk``/``n_k`` and its own row of γ only,
so a chunk's new γ overwrites its old one in place and its rows add into
fresh ``n_dk``/``n_wk`` at once.  That is the JAX package's function
without its four ``[N, K]`` temporaries: at N = 2M tokens and K = 1,000, γ
alone is 8 GB.  The E-step keeps the JAX package's order (Vβ is the
Python double rounded once to float32, divisions are by tensors); the
segment sums add in float64 (``_sums``), where the JAX package adds in
float32, so the two packages agree to float32 rounding, not bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

# the E-step forms its [tokens, K] temporaries this many elements at a time
# (256 MB of float32 each)
_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class EMConfig:
    num_topics: int
    vocab_size: int
    alpha: float = 0.1
    beta: float = 0.01

    @property
    def K(self):
        return self.num_topics

    @property
    def V(self):
        return self.vocab_size


class EMState(NamedTuple):
    gamma: torch.Tensor   # [N, K] token responsibilities
    ndk: torch.Tensor     # [D, K] expected doc-topic counts
    nwk: torch.Tensor     # [V, K] expected word-topic counts
    nk: torch.Tensor      # [K]


def init_state(seed: int, w: torch.Tensor, d: torch.Tensor,
               valid: torch.Tensor, num_docs: int, cfg: EMConfig) -> EMState:
    """Responsibilities drawn from Dirichlet(1) (each row i.i.d. Exp(1)
    draws over their sum) and the M-step's tables from them, on the device
    of ``w``.  The draws come from a ``torch.Generator`` on that device
    seeded with ``seed`` (Philox on CUDA, the Mersenne twister on the CPU),
    so the card and the CPU draw different states; the JAX package's
    ``jax.random.dirichlet`` is a third.  Runs that must agree start from a
    carried state (``convert.em_state_from_arrays``)."""
    dev = w.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    gamma = torch.empty((w.shape[0], cfg.K), dtype=torch.float32,
                        device=dev).exponential_(generator=gen)
    gamma.div_(gamma.sum(-1, keepdim=True))
    gamma.mul_(valid[:, None])
    return _m_step(gamma, w, d, num_docs, cfg)


def _m_step(gamma, w, d, num_docs, cfg: EMConfig) -> EMState:
    ndk, nwk = _sums(gamma, num_docs, cfg)
    step = _chunk_tokens(cfg)
    for lo in range(0, gamma.shape[0], step):
        _add(ndk, nwk, gamma[lo:lo + step], d[lo:lo + step].long(),
             w[lo:lo + step].long())
    return _state(gamma, ndk, nwk)


def _chunk_tokens(cfg: EMConfig) -> int:
    return max(1, _CHUNK_ELEMS // max(cfg.K, 1))


def _add(ndk, nwk, g, dl, wl) -> None:
    """Add a chunk's responsibilities ``g`` into the float64 segment sums
    at its documents ``dl`` and words ``wl``."""
    g64 = g.double()
    ndk.index_add_(0, dl, g64)
    nwk.index_add_(0, wl, g64)


def _sums(gamma, num_docs: int, cfg: EMConfig):
    """Zeroed float64 accumulators of the two segment sums, [D, K] and
    [V, K].  Each cell of n_wk adds up to every token of its word, tens
    of thousands of responsibilities at a Web-scale corpus's hot words; in
    float32 their rounding does not cancel (at 2M tokens and V = 100,000
    on an H100 it added more than a token of mass), so the sums run in
    float64 and each cell is rounded to float32 once."""
    return (torch.zeros((num_docs, cfg.K), dtype=torch.float64,
                        device=gamma.device),
            torch.zeros((cfg.V, cfg.K), dtype=torch.float64,
                        device=gamma.device))


def _state(gamma, ndk, nwk) -> EMState:
    """The float32 state from float64 segment sums; n_k = Σ_w n_wk."""
    return EMState(gamma, ndk.to(torch.float32), nwk.to(torch.float32),
                   nwk.sum(0).to(torch.float32))


def em_iteration(state: EMState, w, d, valid, num_docs: int,
                 cfg: EMConfig) -> EMState:
    """One E-step and M-step.  The E-step is CVB0-style: each token's own
    responsibility is subtracted, so it sees counts excluding itself, as
    MLlib and Asuncion'09 do.

    Consumes ``state``: the new γ overwrites ``state.gamma`` in place (at
    Web scale γ is the largest tensor, and a second copy would double it),
    while ``n_dk``, ``n_wk`` and ``n_k`` are new.  After the call the
    given state holds this iteration's γ beside the last one's counts, so
    use only the returned state; to keep the given one, pass a copy of its
    γ (``state._replace(gamma=state.gamma.clone())``)."""
    gamma = state.gamma
    ndk_new, nwk_new = _sums(gamma, num_docs, cfg)
    step = _chunk_tokens(cfg)
    for lo in range(0, gamma.shape[0], step):
        g = gamma[lo:lo + step]
        dl, wl = d[lo:lo + step].long(), w[lo:lo + step].long()
        resp = state.ndk[dl].sub_(g).add_(cfg.alpha)           # n_dk^-i + α
        resp.mul_(state.nwk[wl].sub_(g).add_(cfg.beta))        # · n_wk^-i + β
        resp.div_((state.nk[None, :] - g).add_(cfg.V * cfg.beta))
        resp.clamp_min_(0.0)
        resp.div_(resp.sum(-1, keepdim=True).clamp_min_(1e-30))
        resp.mul_(valid[lo:lo + step, None])
        g.copy_(resp)
        del resp
        _add(ndk_new, nwk_new, g, dl, wl)
    return _state(gamma, ndk_new, nwk_new)


def shuffle_bytes_per_iter(num_tokens: int, cfg: EMConfig) -> int:
    """Bytes a map-reduce (GraphX) realisation shuffles per iteration: one
    K-float message per token edge, each direction (doc->word, word->doc).
    This models paper Table 1's 'Shuffle write' column for Spark EM."""
    return 2 * num_tokens * cfg.K * 4


def train(state: EMState, w, d, valid, num_docs: int, cfg: EMConfig,
          num_iters: int) -> EMState:
    """``num_iters`` EM iterations.  Consumes ``state`` as
    ``em_iteration`` does: its γ ends as the last iteration's."""
    for _ in range(num_iters):
        state = em_iteration(state, w, d, valid, num_docs, cfg)
    return state
