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
whole matrix and every moment is the identity.  ``SpmdBackend`` is the
multi-process one: each rank of a ``repro_torch.launch.mesh.Mesh`` holds a
cyclic row shard of the matrix, and the moments are ``torch.distributed``
collectives -- an all-gather over the model (server) axis for pulls, a sum
over the worker axes for pushes, one all-gather per worker axis for
coordinate buffers, and a row slice for localisation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, Tuple, Union, runtime_checkable

import torch

from repro_torch.core.pserver import DistributedMatrix, spmd_pull_all


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


@dataclasses.dataclass(frozen=True)
class SpmdBackend:
    """SPMD backend: runs on every rank of a mesh, one process per rank.

    ``axis_name`` names the worker axes whose push deltas are summed (the
    paper's exactly-once push, one all-reduce); ``model_axis`` names the
    server axis over which ``n_wk`` rows are sharded (pulls all-gather along
    it, localisation keeps this shard's slice).  Either may be None: a
    replicated-matrix data-parallel program sets only ``axis_name``.
    ``mesh`` is the ``launch.mesh.Mesh`` the collectives run on (a JAX
    axis name resolves inside ``shard_map``; here the handle carries its
    mesh).  A backend made without one, as ``PSClient.create(axis_name=
    ...)`` makes it, names its axes and raises at its first collective.
    """

    axis_name: Optional[Union[str, Tuple[str, ...]]] = None
    model_axis: Optional[str] = None
    mesh: Any = dataclasses.field(default=None, compare=False, repr=False)

    def _mesh(self):
        if self.mesh is None:
            raise RuntimeError("this SpmdBackend has no mesh: its "
                               "collectives run on the ranks of a "
                               "launch.mesh.Mesh (PSClient.create(mesh=...))")
        return self.mesh

    def pull_full(self, storage: DistributedMatrix) -> DistributedMatrix:
        if self.model_axis is None:
            return storage
        phys = spmd_pull_all(storage.value, self.model_axis,
                             mesh=self._mesh())
        return dataclasses.replace(storage, value=phys)

    def reduce(self, delta: torch.Tensor) -> torch.Tensor:
        if self.axis_name is None:
            return delta
        return self._mesh().all_reduce(delta, self.axis_name, tag="reduce")

    def gather_concat(self, x: torch.Tensor) -> torch.Tensor:
        """Concatenate every worker's buffer along axis 0 -- the COO
        analogue of ``reduce``: the workers' compressed buffers are
        gathered and every entry applied once (value-0 padding stays a
        no-op).  One all-gather per worker axis, in the JAX package's
        order."""
        if self.axis_name is None:
            return x
        axes = (self.axis_name if isinstance(self.axis_name, tuple)
                else (self.axis_name,))
        mesh = self._mesh()
        for ax in axes:
            x = mesh.all_gather(x, ax, tag="gather")
        return x

    def localize(self, full: DistributedMatrix) -> DistributedMatrix:
        if self.model_axis is None:
            return full
        rps = full.layout.rows_per_shard
        i = self._mesh().axis_index(self.model_axis)
        return dataclasses.replace(
            full, value=full.value[i * rps:(i + 1) * rps].clone())
