"""Declarative push routes (paper section 3.3 as policy objects).

A ``PushRoute`` decides *how a batch of topic reassignments travels to the
parameter server*: fully dense (the hot-word buffer generalised to every
word), fully compressed ``(row, col, +-1)`` coordinate deltas (the paper's
100k-reassignment message), or the paper's own hybrid -- dense for the
``H`` hottest words, coordinates for the cold tail.  Every route is integer
addition underneath, so the choice never changes values, only the shape of
the traffic; the executors and tests rely on that.

  * ``DenseRoute()``             -- everything through the dense path;
  * ``CooRoute()``               -- everything as coordinate deltas;
  * ``HybridRoute(hot_words=H)`` -- hot prefix dense, cold tail as
    coordinates.

``plan`` produces the traffic plan (dense part + coordinate part);
``block_delta`` materialises it into one dense delta for callers that merge
group-locally (the pipelined executor's block write-back).  The dense part
is built by the ``delta_push`` kernel and the coordinate part applied by
``delta_apply_coo`` on a card; their plain versions run on the CPU
(``kernels.ops``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import delta_push as _delta


class Reassign(NamedTuple):
    """One batch of topic reassignments, the unit every route consumes.

    ``rows`` are row ids in the *aggregation space* (logical word ids for a
    full-matrix push, block-local physical ids inside the pipelined
    executor); ``words`` are always the logical word ids -- the hot/cold
    boundary classifies on these (frequency-ordered, so hot words are an id
    prefix).  ``changed`` already folds in validity.
    """

    rows: torch.Tensor     # [B] int32, aggregation-space row ids
    words: torch.Tensor    # [B] int32, logical word ids (hot/cold split)
    z_old: torch.Tensor    # [B] int32
    z_new: torch.Tensor    # [B] int32
    changed: torch.Tensor  # [B] bool, True where z_old != z_new and valid


class RouteDelta(NamedTuple):
    """A route's traffic plan for one ``Reassign`` batch.

    ``dense`` is a **prefix-shaped** ``[R, K]`` int32 delta for the first
    ``R`` rows of the aggregation space (None when nothing goes densely):
    ``R == num_rows`` is the full-matrix case, the hybrid ships ``R ==
    hot_words``.  ``coo`` is a ``(rows, cols, +-1 vals)`` triple in the
    aggregation row space (or None); value-0 entries are padding.
    """

    dense: Optional[torch.Tensor]
    coo: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _dense_delta(rows, z_old, z_new, amount, num_rows: int,
                 num_topics: int) -> torch.Tensor:
    """Dense [num_rows, K] delta of the masked reassignments ``amount``
    (the ``delta_push`` kernel on a card).  ``rows`` outside ``[0,
    num_rows)`` must carry ``amount == 0`` (the hybrid's masked hot
    aggregation); they add nothing."""
    from repro_torch.kernels import ops
    return ops.delta_push(rows, z_old, z_new, amount, num_rows, num_topics)


def _apply_coo(dense: torch.Tensor, coo) -> torch.Tensor:
    """Add a coordinate buffer into ``dense`` in place (the
    ``delta_apply_coo`` kernel on a card); returns it."""
    from repro_torch.kernels import ops
    rows, cols, vals = coo
    return ops.delta_apply_coo(rows, cols, vals, dense.shape[0],
                               dense.shape[1], out=dense)


def partition_by_mask(re: Reassign, keep) -> Tuple[Reassign, int]:
    """Host-side stable partition of a batch by a membership mask: tokens
    with ``keep[i]`` True come first.  Returns ``(reordered, prefix)``,
    ``prefix`` the count of leading kept tokens.  Reordering never changes
    the applied delta: scatter-adds commute."""
    keep = np.asarray(torch.as_tensor(keep).cpu(), dtype=bool)
    order = torch.as_tensor(np.argsort(~keep, kind="stable"),
                            device=re.rows.device)
    return Reassign(*[x[order] for x in re]), int(keep.sum())


def partition_reassign(re: Reassign, hot_words: int
                       ) -> Tuple[Reassign, int]:
    """Host-side stable partition at the hot/cold boundary: tokens with
    ``word < hot_words`` first.  Feeding the result to
    ``HybridRoute.plan(..., hot_prefix=...)`` sizes the cold buffer to the
    post-split tail instead of the whole batch."""
    return partition_by_mask(re, (re.words < hot_words).cpu().numpy())


@dataclasses.dataclass(frozen=True)
class PushRoute:
    """Base policy.  Subclasses define ``plan``; ``block_delta`` is the
    shared materialisation used by group-local merges."""

    @property
    def label(self) -> str:
        """Short stable name for metrics/trace labels ("dense" / "coo" /
        "hybrid")."""
        return type(self).__name__.replace("Route", "").lower()

    def traffic(self, batch: int, num_rows: int, num_topics: int,
                hot_prefix: Optional[int] = None) -> dict:
        """Static traffic shape of one ``plan`` for a ``batch``-sized
        reassignment batch: dense rows/bytes shipped, coordinate
        capacity/bytes (each entry a ``(row, col, val)`` int32 triple), and
        the entries the client aggregates (``split_entries``) and the
        server applies (``apply_entries``).  From shapes only."""
        dense_cells = num_rows * num_topics
        return {"dense_rows": num_rows,
                "dense_bytes": dense_cells * 4,
                "coo_cap": 0, "coo_bytes": 0,
                "split_entries": 2 * batch,
                "apply_entries": dense_cells}

    def plan(self, re: Reassign, num_rows: int, num_topics: int, *,
             prefix_rows: bool = False,
             hot_prefix: Optional[int] = None) -> RouteDelta:
        """Plan the traffic for one batch.  ``prefix_rows=True`` says that
        ``re.rows`` are the logical word ids themselves (hot words form an
        id prefix -- the hybrid's prefix-shaped dense block);
        ``hot_prefix`` asserts the first N tokens are the hot ones
        (``partition_reassign``).  Neither ever changes values."""
        raise NotImplementedError

    def block_delta(self, re: Reassign, num_rows: int, num_topics: int, *,
                    prefix_rows: bool = False) -> torch.Tensor:
        """Materialise ``plan`` as one dense [num_rows, K] int32 delta:
        a prefix-shaped dense block padded back out, the coordinate part
        applied into it."""
        d = self.plan(re, num_rows, num_topics, prefix_rows=prefix_rows)
        if d.dense is None:
            dense = torch.zeros((num_rows, num_topics), dtype=torch.int32,
                                device=re.rows.device)
        elif d.dense.shape[0] < num_rows:
            dense = torch.nn.functional.pad(
                d.dense, (0, 0, 0, num_rows - d.dense.shape[0]))
        else:
            dense = d.dense
        if d.coo is not None:
            _apply_coo(dense, d.coo)
        return dense


@dataclasses.dataclass(frozen=True)
class DenseRoute(PushRoute):
    """All words through the dense path."""

    def plan(self, re: Reassign, num_rows: int, num_topics: int, *,
             prefix_rows: bool = False,
             hot_prefix: Optional[int] = None) -> RouteDelta:
        return RouteDelta(_dense_delta(re.rows, re.z_old, re.z_new,
                                       re.changed, num_rows, num_topics),
                          None)


@dataclasses.dataclass(frozen=True)
class CooRoute(PushRoute):
    """Every reassignment as a compressed coordinate delta -- the paper's
    per-reassignment message with no dense buffer at all."""

    def traffic(self, batch: int, num_rows: int, num_topics: int,
                hot_prefix: Optional[int] = None) -> dict:
        # two entries per reassignment, worst case every token changed
        return {"dense_rows": 0, "dense_bytes": 0,
                "coo_cap": 2 * batch, "coo_bytes": 2 * batch * 3 * 4,
                "split_entries": 0, "apply_entries": 2 * batch}

    def plan(self, re: Reassign, num_rows: int, num_topics: int, *,
             prefix_rows: bool = False,
             hot_prefix: Optional[int] = None) -> RouteDelta:
        return RouteDelta(None, _delta.cold_coo(re.rows, re.z_old, re.z_new,
                                                re.changed))


@dataclasses.dataclass(frozen=True)
class HybridRoute(PushRoute):
    """Paper section 3.3 verbatim: the ``hot_words`` hottest words (a
    logical-id prefix under frequency ordering) aggregate densely, the cold
    tail travels as coordinate deltas."""

    hot_words: int = 2000

    def clamped(self, num_rows: int) -> int:
        """The effective hot boundary, ``hot_words`` clamped to ``[0,
        num_rows]``: the one clamp both ``traffic`` and ``plan`` use."""
        return min(max(int(self.hot_words), 0), num_rows)

    def traffic(self, batch: int, num_rows: int, num_topics: int,
                hot_prefix: Optional[int] = None) -> dict:
        hot = self.clamped(num_rows)
        if hot == 0:
            return CooRoute().traffic(batch, num_rows, num_topics)
        if hot >= num_rows:
            return DenseRoute().traffic(batch, num_rows, num_topics)
        cold_cap = (2 * batch if hot_prefix is None
                    else 2 * max(batch - min(hot_prefix, batch), 0))
        hot_tokens = batch if hot_prefix is None else min(hot_prefix, batch)
        dense_cells = hot * num_topics
        return {"dense_rows": hot, "dense_bytes": dense_cells * 4,
                "coo_cap": cold_cap, "coo_bytes": cold_cap * 3 * 4,
                "split_entries": 2 * hot_tokens,
                "apply_entries": dense_cells + cold_cap}

    def plan(self, re: Reassign, num_rows: int, num_topics: int, *,
             prefix_rows: bool = False,
             hot_prefix: Optional[int] = None) -> RouteDelta:
        hot = self.clamped(num_rows)
        if hot == 0:          # degenerate: everything cold, pure COO
            return RouteDelta(None, _delta.cold_coo(
                re.rows, re.z_old, re.z_new, re.changed))
        if hot >= num_rows:   # degenerate: everything hot, pure dense
            return RouteDelta(_dense_delta(re.rows, re.z_old, re.z_new,
                                           re.changed, num_rows, num_topics),
                              None)
        if not prefix_rows:
            # block-local row space: hot words are not a row prefix here,
            # so the dense half spans every row of the block
            hot_m, cold_m = _delta.split_hot_cold(re.words, re.changed, hot)
            dense = _dense_delta(re.rows, re.z_old, re.z_new, hot_m,
                                 num_rows, num_topics)
            return RouteDelta(dense, _delta.cold_coo(re.rows, re.z_old,
                                                     re.z_new, cold_m))
        # prefix row space (rows ARE logical word ids): the dense block is
        # [hot, K] and travels at that size
        if hot_prefix is not None:
            hp = min(hot_prefix, re.rows.shape[0])
            d_hot = _dense_delta(re.rows[:hp], re.z_old[:hp], re.z_new[:hp],
                                 re.changed[:hp], hot, num_topics)
            coo = None
            if hp < re.rows.shape[0]:
                coo = _delta.cold_coo(re.rows[hp:], re.z_old[hp:],
                                      re.z_new[hp:], re.changed[hp:])
            return RouteDelta(d_hot, coo)
        hot_m, cold_m = _delta.split_hot_cold(re.words, re.changed, hot)
        d_hot = _dense_delta(re.rows, re.z_old, re.z_new, hot_m, hot,
                             num_topics)
        return RouteDelta(d_hot, _delta.cold_coo(re.rows, re.z_old, re.z_new,
                                                 cold_m))


def route_for(hot_words: Optional[int], vocab_size: int) -> PushRoute:
    """Map the scalar ``hot_words`` knob onto a route: ``None`` (or a
    boundary covering the vocabulary) is dense, ``0`` all-coordinates,
    anything else the paper's hybrid."""
    if hot_words is None or hot_words >= vocab_size:
        return DenseRoute()
    if hot_words <= 0:
        return CooRoute()
    return HybridRoute(hot_words=int(hot_words))
