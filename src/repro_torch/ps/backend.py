"""Swappable parameter-server backends (paper section 2).

A ``Backend`` realises the collective moments of the paper's pull/push
protocol for one execution substrate; layout, routes and handles do not
depend on it:

  * ``pull_full``     -- the full physical matrix from what this worker
    holds (the paper's snapshot pull, section 2.3);
  * ``reduce``        -- combine the dense push deltas of all workers
    exactly once (sections 2.4-2.5);
  * ``gather_concat`` -- concatenate all workers' coordinate buffers (the
    COO analogue of ``reduce``);
  * ``localize``      -- keep only this server shard's rows.

``InProcessBackend`` is the single-process backend: one process holds the
whole matrix and every moment is the identity.  The multi-process backend
(``torch.distributed`` collectives) belongs to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple, Union, runtime_checkable

import torch

from repro_torch.core.pserver import DistributedMatrix


@runtime_checkable
class Backend(Protocol):
    """The backend contract: the collective moments plus the two axis
    names that tell handles which collectives are live (both None on a
    single-process backend)."""

    axis_name: Optional[Union[str, Tuple[str, ...]]]
    model_axis: Optional[str]

    def pull_full(self, storage: DistributedMatrix) -> DistributedMatrix:
        ...

    def reduce(self, delta: torch.Tensor) -> torch.Tensor:
        ...

    def gather_concat(self, x: torch.Tensor) -> torch.Tensor:
        ...

    def localize(self, full: DistributedMatrix) -> DistributedMatrix:
        ...


@dataclasses.dataclass(frozen=True)
class InProcessBackend:
    """Single-process backend: the whole matrix lives here; every moment
    is the identity."""

    axis_name = None
    model_axis = None

    def pull_full(self, storage: DistributedMatrix) -> DistributedMatrix:
        return storage

    def reduce(self, delta: torch.Tensor) -> torch.Tensor:
        return delta

    def gather_concat(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def localize(self, full: DistributedMatrix) -> DistributedMatrix:
        return full
