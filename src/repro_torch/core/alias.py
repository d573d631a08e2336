"""Vose alias tables in PyTorch (paper section 3, reference [14]).

LightLDA's amortised O(1) word-proposal draws come from alias tables built
once per snapshot from the word-topic counts.  This module implements

  * ``build_alias_rows`` -- exact Vose construction for a [V, K] block,
  * ``alias_sample``     -- O(1) draw given (prob, alias) rows and uniforms,
  * ``alias_pmf``        -- the pmf a table induces (for tests).

``build_alias_rows`` is the plain version behind the hand-written
``alias_build`` kernel (``repro_torch.kernels.alias_build``): the two-stack
algorithm runs as a bounded loop of ``2K`` vectorised steps over all rows at
once (each step retires one "small" entry per row; each index enters the
small stack at most once), with fixed-size stacks and counters.  The kernel
replays the same retirement order without stacks, so the two are bitwise
equal in ``prob`` and ``alias``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# the reduce-window width XLA's CPU backend splits a long row sum into
_XLA_WINDOW = 32


class AliasTable(NamedTuple):
    """Alias table rows.  ``prob[i]`` is the acceptance probability of bucket
    ``i``; on rejection the draw is ``alias[i]``."""

    prob: torch.Tensor   # [..., K] float32
    alias: torch.Tensor  # [..., K] int32


def _col(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat[r, idx_r] for every row r."""
    return mat.gather(1, idx[:, None])[:, 0]


def _set_col(mat: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    mat.scatter_(1, idx[:, None], val[:, None].to(mat.dtype))


def row_sum(p_rows: torch.Tensor) -> torch.Tensor:
    """Row sums of ``p_rows`` [V, K] in the order XLA's CPU backend takes
    them, so that the alias tables equal the JAX package's bitwise.

    XLA rewrites a row reduction longer than 32 as a reduce-window of
    size and stride 32 (the columns padded with zeros, half of the padding
    before them and half after), then reduces the window sums, again in
    windows while more than 32 remain.  Each window, and the last reduce,
    adds from left to right.  Written as elementwise adds, the order is
    the same on every device.
    """
    while p_rows.shape[1] > _XLA_WINDOW:
        pad = (-p_rows.shape[1]) % _XLA_WINDOW
        p_rows = torch.nn.functional.pad(p_rows, (pad // 2, pad - pad // 2))
        p_rows = _sum_left_to_right(
            p_rows.reshape(p_rows.shape[0], -1, _XLA_WINDOW))
    return _sum_left_to_right(p_rows)


def _sum_left_to_right(x: torch.Tensor) -> torch.Tensor:
    """((x[..., 0] + x[..., 1]) + x[..., 2]) + ... over the last axis."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def build_alias_rows(p_rows: torch.Tensor) -> AliasTable:
    """Vose construction for every row of ``p_rows`` [V, K] (unnormalised
    weights); sampling bucket ``i ~ U{0..K-1}`` and accepting with
    ``prob[i]`` (else ``alias[i]``) draws exactly from ``p / p.sum()``."""
    v, k = p_rows.shape
    dev = p_rows.device
    psum = torch.clamp_min(row_sum(p_rows)[:, None], 1e-30)
    # a tensor numerator: ``k / psum`` would be ``psum.reciprocal() * k``
    q = p_rows.float() * (psum.new_tensor(float(k)) / psum)   # mean 1

    is_small = q < 1.0
    idx = torch.arange(k, dtype=torch.int64, device=dev).expand(v, k)
    # stack slots from cumulative counts; non-members go to the spare slot k
    small_pos = torch.cumsum(is_small, 1) - 1
    large_pos = torch.cumsum(~is_small, 1) - 1
    small = torch.zeros((v, k + 1), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(is_small, small_pos, k), idx)[:, :k].contiguous()
    large = torch.zeros((v, k + 1), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(~is_small, large_pos, k), idx)[:, :k].contiguous()
    n_small = is_small.sum(-1)
    n_large = k - n_small

    prob = torch.ones((v, k), dtype=torch.float32, device=dev)
    alias = idx.clone()
    for _ in range(2 * k):
        active = (n_small > 0) & (n_large > 0)
        if not bool(active.any()):
            break                       # every later step is a no-op
        s = _col(small, torch.clamp_min(n_small - 1, 0))
        l = _col(large, torch.clamp_min(n_large - 1, 0))
        q_s = _col(q, s)
        q_l = _col(q, l)
        _set_col(prob, s, torch.where(active, q_s, _col(prob, s)))
        _set_col(alias, s, torch.where(active, l, _col(alias, s)))
        q_l_new = q_l + q_s - 1.0
        _set_col(q, l, torch.where(active, q_l_new, q_l))

        n_small_after = torch.where(active, n_small - 1, n_small)
        # donor exhausted below 1: move it from the large to the small stack
        demote = active & (q_l_new < 1.0)
        n_large = torch.where(demote, n_large - 1, n_large)
        slot = torch.clamp_max(n_small_after, k - 1)
        _set_col(small, slot, torch.where(demote, l, _col(small, slot)))
        n_small = torch.where(demote, n_small_after + 1, n_small_after)
    return AliasTable(torch.clamp(prob, 0.0, 1.0), alias.to(torch.int32))


def alias_sample(prob: torch.Tensor, alias: torch.Tensor,
                 u: torch.Tensor) -> torch.Tensor:
    """O(1) alias draw with the single-uniform trick.

    ``prob``/``alias`` are the table rows *already gathered per draw*
    ([..., K]); ``u`` is uniform [0,1) of the batch shape.  The integer part
    of ``u*K`` picks the bucket, the fractional remainder is the accept
    coin -- one random number per draw, as in LightLDA.
    """
    k = prob.shape[-1]
    scaled = u * k
    bucket = torch.clamp_max(scaled.to(torch.int32), k - 1)
    coin = scaled - bucket
    b = bucket.long()[..., None]
    p = prob.gather(-1, b)[..., 0]
    a = alias.gather(-1, b)[..., 0]
    return torch.where(coin < p, bucket, a)


def alias_pmf(table: AliasTable) -> torch.Tensor:
    """Exact pmf induced by an alias table: each bucket i contributes
    prob[i]/K to i and (1-prob[i])/K to alias[i]."""
    prob, alias = table
    k = prob.new_tensor(float(prob.shape[-1]))
    direct = prob / k
    spill = (1.0 - prob) / k
    return direct.scatter_add(-1, alias.long(), spill)
