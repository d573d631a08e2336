"""Distributed LightLDA on the parameter server (paper section 3, Alg. 1).

Collapsed Gibbs sampling for LDA keeps three count statistics -- ``n_k``
(tokens per topic), ``n_wk`` (word w in topic k) and ``n_dk`` (tokens of doc d
in topic k) -- and resamples every token's topic ``z`` from

  P(z=k) ∝ (n_dk^{-dw} + α) · (n_wk^{-dw} + β) / (n_k^{-dw} + Vβ).

LightLDA factorises this into a *doc proposal* ``q_d(k) ∝ n_dk + α`` (drawn
O(1) by picking a random token's current assignment, or the α-branch) and a
*word proposal* ``q_w(k) ∝ (n_wk + β)/(n_k + Vβ)`` (drawn O(1) from a Vose
alias table), with an MH acceptance test after each.

``n_wk`` lives on the parameter server (a ``ps.MatrixHandle``, cyclic over
servers), ``n_k`` beside it (a replicated ``ps.VectorHandle``), and ``n_dk``
stays with the worker that owns the documents.

This module holds the config, the pre-drawn randomness (``MHRandoms``,
``draw_mh_randoms``, ``make_doc_draw``), the chain itself (``mh_chain``, the
plain version behind the hand-written ``mh_sample`` kernel), the sampler
state and its initialisation, the sweeps (routed through
``train.async_exec``) with the synchronous blocked oracle
``sweep_blocked_ref``, and the frozen-model entry points of serving.  Every
floating-point expression and every random draw keeps the JAX package's
order, so a sweep is bitwise equal to its, given the same key.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import ps
from repro_torch import rng as jrng
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


class SamplerState(NamedTuple):
    """Full sampler state.  Token tensors are flat and padded to a multiple
    of ``block_tokens`` (padding has ``valid == False``).  A sweep returns a
    new state and never writes into the tensors of the one it was given."""

    w: torch.Tensor          # [N] int32 word ids (frequency-ordered)
    d: torch.Tensor          # [N] int32 doc ids (local to this worker)
    z: torch.Tensor          # [N] int32 topic assignments
    valid: torch.Tensor      # [N] bool, False for padding
    doc_start: torch.Tensor  # [D] int32 first token index of each doc
    doc_len: torch.Tensor    # [D] int32 token count of each doc
    nwk: "ps.MatrixHandle"   # (V, K) word-topic counts (PS client handle)
    nk: "ps.VectorHandle"    # (K,)  topic counts (PS client handle)
    ndk: torch.Tensor        # [D, K] int32 doc-topic counts (worker-local)


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def init_state(key: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
               num_docs: int, cfg: LDAConfig,
               doc_start: Optional[torch.Tensor] = None,
               doc_len: Optional[torch.Tensor] = None,
               client: Optional["ps.PSClient"] = None) -> SamplerState:
    """Random topic init (``randint`` from ``key`` itself) and the count
    tables rebuilt from it -- the same routine is the paper's
    fault-tolerance recovery (section 3.5).  The state lies on the device
    of ``w``."""
    from repro_torch.kernels import ops

    dev = w.device
    n = w.shape[0]
    pad = (-n) % cfg.block_tokens
    z = ops.randint(key.to(dev), (n,), 0, cfg.K)

    def padded(x, fill):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                        device=dev)])

    w = padded(w.to(torch.int32), 0)
    d = padded(d.to(dev, torch.int32), 0)
    z = padded(z, 0)
    valid = padded(torch.ones((n,), dtype=torch.bool, device=dev), False)
    if doc_start is None or doc_len is None:
        doc_len = torch.zeros((num_docs,), dtype=torch.int32,
                              device=dev).index_add_(
            0, d[:n].long(), torch.ones((n,), dtype=torch.int32, device=dev))
        doc_start = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                           device=dev),
                               torch.cumsum(doc_len, 0)[:-1].to(torch.int32)])
    nwk, nk, ndk = rebuild_counts(w, d, z, valid, num_docs, cfg,
                                  client=client)
    return SamplerState(w, d, z, valid, doc_start.to(dev, torch.int32),
                        doc_len.to(dev, torch.int32), nwk, nk, ndk)


def rebuild_counts(w, d, z, valid, num_docs: int, cfg: LDAConfig,
                   client: Optional["ps.PSClient"] = None
                   ) -> Tuple["ps.MatrixHandle", "ps.VectorHandle",
                              torch.Tensor]:
    """Rebuild (n_wk, n_k, n_dk) from assignments (paper section 3.5).
    Counts come back as PS client handles (``client``, or an in-process
    client for ``cfg.num_shards`` cyclic shards)."""
    if client is None:
        client = ps.client_for(cfg)
    dev = w.device
    one = valid.to(torch.int32)
    wl, dl, zl = w.long(), d.long(), z.long()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    nwk_dense = zeros(cfg.V, cfg.K).index_put_((wl, zl), one,
                                               accumulate=True)
    nk = zeros(cfg.K).index_put_((zl,), one, accumulate=True)
    ndk = zeros(num_docs, cfg.K).index_put_((dl, zl), one, accumulate=True)
    return client.matrix_from_dense(nwk_dense), client.wrap_vector(nk), ndk


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


def draw_mh_randoms(key: torch.Tensor, doc_draw_fn, batch: int,
                    cfg: LDAConfig) -> MHRandoms:
    """The chain's randoms for ``batch`` tokens from one key: split in
    four, the doc proposals drawn with ``doc_draw_fn`` over
    ``split(kd, mh_steps)`` (jax's ``vmap``, written as a key batch)."""
    kw, kwa, kd, kda = jrng.split(key, 4)
    shape = (cfg.mh_steps, batch)
    return MHRandoms(u_word=jrng.uniform(kw, shape),
                     u_waccept=jrng.uniform(kwa, shape),
                     z_doc=doc_draw_fn(jrng.split(kd, cfg.mh_steps)),
                     u_daccept=jrng.uniform(kda, shape))


def make_doc_draw(d_b: torch.Tensor, z_snapshot: torch.Tensor,
                  doc_start: torch.Tensor, doc_len: torch.Tensor,
                  cfg: LDAConfig):
    """The O(1) doc-proposal draw for a block of tokens.

    q_d(k) = (n_dk + α) / (N_d + Kα) is sampled without touching n_dk:
    with probability N_d/(N_d+Kα) take the assignment of a uniformly random
    token of doc d (in ``z_snapshot``, the block-start assignments), else a
    uniform topic.  The returned function maps a batch of keys [S, 2] to
    [S, B] proposals.
    """
    dl = d_b.long()
    nd = doc_len[dl].to(torch.float32)
    starts = doc_start[dl]
    b = d_b.shape[0]

    def draw(keys: torch.Tensor) -> torch.Tensor:
        k = jrng.split(keys, 3)
        k1, k2, k3 = k[..., 0, :], k[..., 1, :], k[..., 2, :]
        pos = (jrng.uniform(k1, b) * torch.clamp_min(nd, 1.0)).to(
            torch.int32)
        pos = torch.minimum(pos, torch.clamp_min(nd.to(torch.int32) - 1, 0))
        z_tok = z_snapshot[(starts + pos).long()]
        z_unif = jrng.randint(k2, b, 0, cfg.K)
        use_tok = jrng.uniform(k3, b) * (nd + cfg.K * cfg.alpha) < nd
        return torch.where(use_tok, z_tok, z_unif)

    return draw


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


# ---------------------------------------------------------------------------
# One full sweep over the local token shard (Alg. 1 of the paper).
# ---------------------------------------------------------------------------

def sweep(state: SamplerState, key: torch.Tensor, cfg: LDAConfig,
          staleness: int = 0, hot_words: Optional[int] = None,
          route: Optional["ps.PushRoute"] = None) -> SamplerState:
    """Resample every token once (one Gibbs sweep == one paper
    "iteration"), through the full-snapshot executor
    (``train.async_exec.snapshot_sweep``).  ``staleness`` selects the
    bounded-staleness schedule and ``route`` (or ``hot_words``) the push
    policy; the defaults are the synchronous per-block schedule."""
    from repro_torch.train import async_exec
    return async_exec.snapshot_sweep(state, key, cfg, staleness=staleness,
                                     hot_words=hot_words, route=route)


def train(state: SamplerState, key: torch.Tensor, cfg: LDAConfig,
          num_sweeps: int) -> SamplerState:
    """Run ``num_sweeps`` Gibbs sweeps, ``key, sub = split(key)`` before
    each."""
    from repro_torch.kernels import ops

    for _ in range(num_sweeps):
        key, sub = ops.split(key)
        state = sweep(state, sub, cfg)
    return state


# ---------------------------------------------------------------------------
# Blocked / pipelined sweep (paper section 3.4).
#
# The full-snapshot sweep holds n_wk whole on the worker; the Web-scale
# setting cannot.  LightLDA iterates over *model blocks* instead: pull a set
# of word rows, build alias tables for those words only, resample only the
# tokens whose word falls in the block, push the deltas.  Worker memory is
# O(block x K).  Tokens are grouped by their word's physical block on the
# host (``block_token_index``).
# ---------------------------------------------------------------------------

def block_token_index(w: np.ndarray, valid: np.ndarray, rows_per_block: int,
                      layout, cap_round: int = 256,
                      cap: Optional[int] = None) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """Host-side: group token indices by their word's *physical* model
    block.  Returns (block_idx [n_blocks, cap] int32, block_valid
    [n_blocks, cap] bool).  Tokens stay in document order; pad entries
    point at token 0 with valid=False (the sweeps add with
    duplicate-tolerant adds).  The capacity is the hottest block's token
    count rounded up to ``cap_round``, or ``cap`` (raising if a block
    overflows it)."""
    phys = np.asarray(layout.to_physical(np.asarray(w).astype(np.int64)))
    valid = np.asarray(valid)
    block = phys // rows_per_block
    n_blocks = layout.pad_rows // rows_per_block
    counts = np.bincount(block[valid], minlength=n_blocks)
    need = max(int(counts.max()) if counts.size else 0, 1)
    if cap is None:
        cap = -(-need // cap_round) * cap_round
    elif need > cap:
        raise ValueError(f"block capacity {cap} overflows: hottest block "
                         f"holds {need} tokens")
    idx = np.zeros((n_blocks, cap), np.int32)
    bval = np.zeros((n_blocks, cap), bool)
    tok = np.nonzero(valid)[0]                       # token order
    order = np.argsort(block[tok], kind="stable")    # by block, ties in order
    tok = tok[order]
    bs = block[tok]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(tok.shape[0]) - starts[bs]
    idx[bs, slot] = tok
    bval[bs, slot] = True
    return idx, bval


def sweep_blocked(state: SamplerState, key: torch.Tensor, cfg: LDAConfig,
                  block_idx: torch.Tensor, block_valid: torch.Tensor,
                  rows_per_block: int, staleness: int = 0,
                  hot_words: Optional[int] = None,
                  route: Optional["ps.PushRoute"] = None) -> SamplerState:
    """One sweep processing the model in pulled blocks (paper section
    3.4), through the pipelined executor
    (``train.async_exec.pipelined_sweep``).  The defaults equal
    ``sweep_blocked_ref`` bitwise."""
    from repro_torch.train import async_exec
    return async_exec.pipelined_sweep(state, key, cfg, block_idx,
                                      block_valid, rows_per_block,
                                      staleness=staleness,
                                      hot_words=hot_words, route=route)


def sweep_blocked_ref(state: SamplerState, key: torch.Tensor,
                      cfg: LDAConfig, block_idx: torch.Tensor,
                      block_valid: torch.Tensor,
                      rows_per_block: int) -> SamplerState:
    """Synchronous blocked sweep, kept as the executor's oracle: every
    model block does pull -> sample -> push on the critical path, with the
    plain chain and plain scatter-adds.  The pipelined executor with
    ``staleness=0`` must match it bitwise.

    Per model block b:
      1. pull physical rows [b*rpb, (b+1)*rpb),
      2. build alias tables for those rows only,
      3. resample this block's tokens (gathered by ``block_token_index``),
      4. aggregate deltas densely [rpb, K] and push.
    """
    from repro_torch.core import alias as alias_mod
    from repro_torch.kernels import ops

    rpb = rows_per_block
    layout = state.nwk.layout
    n_blocks = block_idx.shape[0]
    cap = block_idx.shape[1]
    assert n_blocks * rpb == layout.pad_rows, (layout.pad_rows, rpb)
    dev = state.w.device
    nwk_phys = state.nwk.value.clone()
    nk, ndk, z_flat = state.nk.value, state.ndk, state.z.clone()
    keys = ops.split(key, n_blocks)
    for blk in range(n_blocks):
        # 1. pull this block's rows (physical/cyclic order)
        rows = nwk_phys[blk * rpb:(blk + 1) * rpb].clone()

        # 2. alias tables for the block only
        weights = (rows.to(torch.float32) + cfg.beta) / (
            nk.to(torch.float32)[None, :] + cfg.V * cfg.beta)
        table = alias_mod.build_alias_rows(weights)

        # 3. resample the block's tokens
        idx = block_idx[blk].long()
        vb = block_valid[blk]
        wb = state.w[idx]
        db = state.d[idx]
        z0 = z_flat[idx]
        local = torch.clamp(layout.to_physical(wb) - blk * rpb, 0,
                            rpb - 1).long()
        dl = db.long()
        doc_draw = make_doc_draw(db, z_flat, state.doc_start, state.doc_len,
                                 cfg)
        rng = draw_mh_randoms(keys[blk], doc_draw, cap, cfg)
        z_new = mh_chain(rng, z0, rows[local], ndk[dl], nk,
                         table.prob[local], table.alias[local], cfg)
        z_new = torch.where(vb, z_new, z0)

        # 4. duplicate-tolerant add updates (pads contribute zero)
        amt = ((z_new != z0) & vb).to(torch.int32)
        d_rows = (torch.zeros((rpb, cfg.K), dtype=torch.int32, device=dev)
                  .index_put_((local, z0.long()), -amt, accumulate=True)
                  .index_put_((local, z_new.long()), amt, accumulate=True))
        nwk_phys[blk * rpb:(blk + 1) * rpb] = rows + d_rows
        nk = nk + (torch.zeros((cfg.K,), dtype=torch.int32, device=dev)
                   .index_put_((z0.long(),), -amt, accumulate=True)
                   .index_put_((z_new.long(),), amt, accumulate=True))
        ndk = (ndk.index_put((dl, z0.long()), -amt, accumulate=True)
               .index_put_((dl, z_new.long()), amt, accumulate=True))
        z_flat.index_put_((idx,), torch.where(vb, z_new - z0, 0),
                          accumulate=True)
    return SamplerState(state.w, state.d, z_flat, state.valid,
                        state.doc_start, state.doc_len,
                        state.nwk.with_value(nwk_phys),
                        state.nk.with_value(nk), ndk)
