"""The parameter server's storage layer, in one process (paper section 2).

A *distributed matrix* and a *distributed vector* with the paper's two
primitives:

  * ``pull`` -- read rows (idempotent; paper section 2.3),
  * ``push`` -- additive update of rows (commutative and associative; paper
    sections 2.4-2.5, so exactly-once semantics reduce to "apply each delta
    once").

Layout follows the paper: **row-wise cyclic partitioning** (section 2.2), so
that frequency-ordered words are load balanced over the servers (section
3.2).  Row ``r`` of the logical matrix lives on shard ``r mod S`` at local
offset ``r div S``; the physical tensor stores each shard's rows
contiguously, shard after shard.

Updates are functional, as in the JAX package: a push returns a new matrix
over a new tensor and leaves the old one as it was, so a sampler state that
callers still hold never changes under them.  Application code goes through
the client API in ``repro_torch/ps``; the raw ``push_sparse`` assumes
in-range logical rows, which ``MatrixHandle.push_coo`` guarantees.  The
SPMD collectives of the JAX package (``spmd_pull_all``/``spmd_push_reduce``)
belong to the multi-process slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class CyclicLayout:
    """Row-cyclic layout of ``num_rows`` logical rows over ``num_shards``.

    ``pad_rows`` is the padded logical row count (a multiple of
    ``num_shards``); physical tensors have ``pad_rows`` rows, each shard's
    rows contiguous.  The index maps are integer formulas that work on
    Python ints, numpy arrays and tensors alike.
    """

    num_rows: int
    num_shards: int

    @property
    def rows_per_shard(self) -> int:
        return _ceil_div(self.num_rows, self.num_shards)

    @property
    def pad_rows(self) -> int:
        return self.rows_per_shard * self.num_shards

    def to_physical(self, row):
        """Logical row id -> physical index in the cyclic tensor."""
        return ((row % self.num_shards) * self.rows_per_shard
                + row // self.num_shards)

    def to_logical(self, phys):
        """Physical index -> logical row id (inverse of ``to_physical``)."""
        return ((phys % self.rows_per_shard) * self.num_shards
                + phys // self.rows_per_shard)

    def shard_of(self, row):
        """Which server shard owns a logical row (paper section 2.2)."""
        return row % self.num_shards

    def permutation(self) -> np.ndarray:
        """Physical -> logical permutation as a numpy array."""
        return self.to_logical(np.arange(self.pad_rows))

    def block_rows(self, block, rows_per_block: int) -> np.ndarray:
        """Logical row ids of physical block ``block`` (padding rows at or
        past ``num_rows`` dropped)."""
        start = int(block) * int(rows_per_block)
        phys = np.arange(start, min(start + int(rows_per_block),
                                    self.pad_rows))
        logical = self.to_logical(phys)
        return logical[logical < self.num_rows]


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


@dataclasses.dataclass(frozen=True)
class DistributedMatrix:
    """The paper's distributed matrix (section 2), cyclic layout.

    ``value`` is the physical tensor ``[layout.pad_rows, cols]``; rows past
    ``num_rows`` are padding and stay zero.
    """

    value: torch.Tensor
    num_rows: int
    num_shards: int

    # --- construction ---
    @classmethod
    def zeros(cls, num_rows: int, cols: int, num_shards: int = 1,
              dtype=torch.int32, device=None) -> "DistributedMatrix":
        layout = CyclicLayout(num_rows, num_shards)
        return cls(torch.zeros((layout.pad_rows, cols), dtype=dtype,
                               device=device), num_rows, num_shards)

    @classmethod
    def from_dense(cls, dense: torch.Tensor,
                   num_shards: int = 1) -> "DistributedMatrix":
        """Build from a logical [num_rows, cols] matrix (copied)."""
        num_rows = dense.shape[0]
        return cls(_to_phys(dense, CyclicLayout(num_rows, num_shards)),
                   num_rows, num_shards)

    # --- properties ---
    @property
    def layout(self) -> CyclicLayout:
        return CyclicLayout(self.num_rows, self.num_shards)

    @property
    def cols(self) -> int:
        return self.value.shape[1]

    def _replace(self, value: torch.Tensor) -> "DistributedMatrix":
        return dataclasses.replace(self, value=value)

    # --- the paper's two primitives -------------------------------------
    def pull(self, rows: torch.Tensor) -> torch.Tensor:
        """Pull logical rows (paper section 2.3); a copy."""
        return self.value[self.layout.to_physical(rows.long())]

    def push(self, rows: torch.Tensor,
             deltas: torch.Tensor) -> "DistributedMatrix":
        """Push additive deltas to logical rows (paper sections 2.4-2.5).
        Duplicate rows accumulate -- addition commutes, so no locking."""
        phys = self.layout.to_physical(rows.long())
        return self._replace(self.value.index_add(
            0, phys, deltas.to(self.value.dtype)))

    def push_dense(self, delta_dense: torch.Tensor) -> "DistributedMatrix":
        """Push a dense logical [num_rows, cols] delta (the flush of the
        paper's hot-word buffer, section 3.3, generalised to every row)."""
        return self._replace(self.value + _to_phys(
            delta_dense, self.layout).to(self.value.dtype))

    def push_prefix(self, delta: torch.Tensor) -> "DistributedMatrix":
        """Push a dense delta covering only the first ``delta.shape[0]``
        logical rows -- the hybrid route's hot-word buffer (section 3.3)
        at its own size.  ``delta.shape[0] == num_rows`` is ``push_dense``."""
        rows = delta.shape[0]
        if rows >= self.num_rows:
            return self.push_dense(delta)
        phys = self.layout.to_physical(_arange(rows, delta))
        return self._replace(self.value.index_add(
            0, phys, delta.to(self.value.dtype)))

    def push_sparse(self, rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor) -> "DistributedMatrix":
        """Push compressed ``(row, col, +-value)`` coordinate deltas -- the
        cold-tail half of the hybrid push (section 3.3), the paper's
        per-reassignment message.  ``rows`` are logical; value-0 entries
        are padding; duplicates accumulate.  Applied by the
        ``delta_apply_coo`` kernel on a card, its plain version on the CPU
        (``kernels.ops``), into a copy of the table."""
        from repro_torch.kernels import ops
        phys = self.layout.to_physical(rows.long())
        new = ops.delta_apply_coo(phys, cols, vals, self.layout.pad_rows,
                                  self.cols, out=self.value.clone())
        return self._replace(new)

    # --- block access for the pipelined sweep (paper section 3.4) -------
    def num_blocks(self, rows_per_block: int) -> int:
        return _ceil_div(self.layout.pad_rows, rows_per_block)

    def block_start(self, block: int, rows_per_block: int) -> int:
        """First physical row of a block, clamped so that the block fits
        (as ``lax.dynamic_slice`` clamps it)."""
        start = int(block) * rows_per_block
        return min(max(start, 0), self.layout.pad_rows - rows_per_block)

    def pull_block(self, block: int, rows_per_block: int) -> torch.Tensor:
        """Pull a contiguous *physical* block of rows (a copy).  Physical
        order is cyclic, so a block touches every shard equally -- the
        section 3.2 balance applied to the section 3.4 block pulls."""
        start = self.block_start(block, rows_per_block)
        return self.value[start:start + rows_per_block].clone()

    def block_logical_rows(self, block: int,
                           rows_per_block: int) -> torch.Tensor:
        start = int(block) * rows_per_block
        return self.layout.to_logical(
            start + _arange(rows_per_block, self.value))

    # --- conversions ------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """The logical [num_rows, cols] matrix (a copy)."""
        return self.value[self.layout.to_physical(
            _arange(self.num_rows, self.value))]


def _to_phys(dense: torch.Tensor, layout: CyclicLayout) -> torch.Tensor:
    """Logical [num_rows, cols] -> physical [pad_rows, cols] (zero padding
    rows at the logical ids past ``num_rows``)."""
    pad = layout.pad_rows - layout.num_rows
    padded = torch.nn.functional.pad(dense, (0, 0, 0, pad))
    perm = torch.as_tensor(layout.permutation(), device=dense.device)
    return padded[perm]


@dataclasses.dataclass(frozen=True)
class DistributedVector:
    """The paper's distributed vector.  For LDA it holds ``n_k``: K
    entries read by every sampling step, so it is replicated."""

    value: torch.Tensor

    @classmethod
    def zeros(cls, n: int, dtype=torch.int32,
              device=None) -> "DistributedVector":
        return cls(torch.zeros((n,), dtype=dtype, device=device))

    def pull(self, idx: torch.Tensor) -> torch.Tensor:
        return self.value[idx.long()]

    def push(self, idx: torch.Tensor,
             deltas: torch.Tensor) -> "DistributedVector":
        return DistributedVector(self.value.index_add(
            0, idx.long(), deltas.to(self.value.dtype)))

    def push_dense(self, delta: torch.Tensor) -> "DistributedVector":
        return DistributedVector(self.value + delta.to(self.value.dtype))


# ---------------------------------------------------------------------------
# Bounded-staleness delta buffer (paper section 3.3 "Buffering").
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaBuffer:
    """Local dense aggregation buffer for additive pushes: the paper's
    hot-word dense matrix (section 3.3) for every word.  ``flush`` pushes
    the buffer and returns it cleared."""

    delta: torch.Tensor  # [num_rows, cols], logical order

    @classmethod
    def zeros(cls, num_rows: int, cols: int, dtype=torch.int32,
              device=None) -> "DeltaBuffer":
        return cls(torch.zeros((num_rows, cols), dtype=dtype, device=device))

    def accumulate(self, rows: torch.Tensor, cols: torch.Tensor,
                   amount: torch.Tensor) -> "DeltaBuffer":
        """Scatter-style accumulation (duplicates add up)."""
        return DeltaBuffer(self.delta.index_put(
            (rows.long(), cols.long()), amount.to(self.delta.dtype),
            accumulate=True))

    def flush(self, matrix: DistributedMatrix
              ) -> Tuple[DistributedMatrix, "DeltaBuffer"]:
        return matrix.push_dense(self.delta), DeltaBuffer(
            torch.zeros_like(self.delta))
