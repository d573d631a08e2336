"""Glint-style parameter-server client API (paper section 2).

The one way the rest of the port touches parameters, mirroring Glint's
client surface:

  * ``PSClient`` is the factory -- ``client.matrix(rows, cols)`` /
    ``client.vector(n)`` return handles, like Glint's
    ``client.matrix[Double](rows, cols)`` returning a ``BigMatrix``;
  * ``MatrixHandle.pull(...)`` / ``pull_block(...)`` / ``pull_all()``
    return ``PullHandle`` futures, ``result()`` awaits them.  In one
    process a pull is a copy made on the tensor's stream, so the handle
    holds that copy; issue -> overlap -> await is still the shape of the
    pipelined executor's prefetch;
  * ``MatrixHandle.push(reassign)`` routes the update through the handle's
    ``PushRoute`` (``ps/routes.py``) and the client's ``Backend``
    (``ps/backend.py``).

Writes are functional -- a push returns a new handle over a new tensor --
except the ``store_block_`` of an executor that owns a private copy of the
table.  All four backends of the JAX package are ported: in-process,
SPMD (``torch.distributed`` collectives over a ``launch.mesh.Mesh``),
tiered and network.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch import obs as _obs
from repro_torch.core.pserver import DistributedMatrix, DistributedVector
from repro_torch.device import Device, resolve_device
from repro_torch.ps.backend import Backend, InProcessBackend, SpmdBackend
from repro_torch.ps.routes import DenseRoute, PushRoute, Reassign, RouteDelta

#: The backend names of the JAX package, all ported.
BACKEND_NAMES = ("in_process", "spmd", "tiered", "net")
_PORTED = BACKEND_NAMES


class BackendConfigError(ValueError):
    """An unknown, unported or mis-configured ``backend=`` selection.
    ``.valid`` lists the names this package accepts."""

    def __init__(self, msg: str, valid: Tuple[str, ...] = _PORTED):
        super().__init__(f"{msg}; valid backends: {', '.join(valid)}")
        self.valid = tuple(valid)


class PullHandle:
    """Future for an issued pull (Glint's asynchronous read, section 2.3).
    In one process the pulled rows are a copy already enqueued on the
    tensor's stream; ``result()`` returns it.  A pull issued on another
    stream (the tiered store's) carries the ``event`` that ends it, and
    ``result()`` makes the caller's stream wait on it."""

    def __init__(self, value: torch.Tensor,
                 event: Optional["torch.cuda.Event"] = None):
        self._value = value
        self._event = event

    def result(self) -> torch.Tensor:
        """Await and return the pulled rows."""
        if self._event is not None:
            torch.cuda.current_stream(self._value.device).wait_event(
                self._event)
            self._event = None
        return self._value

    wait = result                     # Glint naming; identical semantics

    def __repr__(self):
        return f"PullHandle(shape={tuple(self._value.shape)})"


@dataclasses.dataclass(frozen=True)
class MatrixHandle:
    """Client handle for one distributed matrix (Glint's ``BigMatrix``):
    row-cyclic ``storage``, the ``client`` (backend) and the push
    ``route``."""

    storage: DistributedMatrix
    client: "PSClient"
    route: PushRoute

    # --- storage mirror ---------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        """Physical (cyclic-ordered) tensor, [pad_rows, cols]."""
        return self.storage.value

    @property
    def num_rows(self) -> int:
        return self.storage.num_rows

    @property
    def num_shards(self) -> int:
        return self.storage.num_shards

    @property
    def cols(self) -> int:
        return self.storage.cols

    @property
    def layout(self):
        return self.storage.layout

    def to_dense(self) -> torch.Tensor:
        return self.storage.to_dense()

    def num_blocks(self, rows_per_block: int) -> int:
        return self.storage.num_blocks(rows_per_block)

    def block_logical_rows(self, block, rows_per_block: int) -> torch.Tensor:
        return self.storage.block_logical_rows(block, rows_per_block)

    def with_value(self, value: torch.Tensor) -> "MatrixHandle":
        """Same handle over replaced physical storage (client/route kept)."""
        return dataclasses.replace(
            self, storage=dataclasses.replace(self.storage, value=value))

    def with_route(self, route: PushRoute) -> "MatrixHandle":
        return dataclasses.replace(self, route=route)

    def _with(self, storage: DistributedMatrix) -> "MatrixHandle":
        return dataclasses.replace(self, storage=storage)

    # --- pulls (futures) ----------------------------------------------------
    def pull(self, rows: torch.Tensor) -> PullHandle:
        """Pull logical rows (idempotent read, paper section 2.3)."""
        return PullHandle(self.storage.pull(rows))

    def pull_block(self, block, rows_per_block: int) -> PullHandle:
        """Pull a contiguous physical block -- the pipelined executor's
        prefetch unit (paper section 3.4)."""
        return PullHandle(self.storage.pull_block(block, rows_per_block))

    def pull_all(self) -> PullHandle:
        """Pull the full dense logical matrix (the snapshot pull)."""
        full = self.client.backend.pull_full(self.storage)
        return PullHandle(full.to_dense())

    # --- pushes -----------------------------------------------------------
    def push(self, re: Reassign, *,
             hot_prefix: Optional[int] = None) -> "MatrixHandle":
        """Push a reassignment batch through the handle's ``PushRoute``.

        The route plans the traffic (dense / coordinate / hybrid); the dense
        part -- prefix-shaped for the hybrid -- lands through
        ``push_prefix``, the coordinate part through ``push_coo``.  With an
        obs session installed the push records a ``ps.push`` span labelled
        with the route and its traffic shape, and the ``ps.push_ms.<route>``
        / ``ps.push_count.<route>`` metrics; the span syncs the pushed
        value, so it times finished work.
        """
        sp = _obs.span("ps.push", cat="ps")
        if sp is not _obs.NULL_SPAN:
            batch = int(re.rows.shape[0])
            sp.set(route=self.route.label, batch=batch,
                   **self.route.traffic(batch, self.num_rows, self.cols,
                                        hot_prefix=hot_prefix))
        backend = self.client.backend
        plan = self.route.plan(re, self.num_rows, self.cols, prefix_rows=True,
                               hot_prefix=hot_prefix)
        plan = RouteDelta(
            None if plan.dense is None else backend.reduce(plan.dense),
            None if plan.coo is None else tuple(
                backend.gather_concat(x) for x in plan.coo))
        out = self.push_plan(plan)
        if sp is not _obs.NULL_SPAN:
            sp.sync_on(out.value)
            ms = sp.end()
            reg = _obs.metrics_registry()
            if reg is not None:
                reg.histogram(f"ps.push_ms.{self.route.label}").record(ms)
                reg.counter(f"ps.push_count.{self.route.label}").inc()
        return out

    def push_plan(self, plan: RouteDelta) -> "MatrixHandle":
        """Apply an already-planned ``RouteDelta`` (the server half of a
        push): the prefix-dense block through ``push_prefix``, coordinate
        entries through ``push_coo``."""
        out = self
        if plan.dense is not None:
            out = out.push_prefix(plan.dense)
        if plan.coo is not None:
            out = out.push_coo(*plan.coo)
        return out

    def push_dense(self, delta_dense: torch.Tensor) -> "MatrixHandle":
        """Push a dense logical [num_rows, cols] delta."""
        return self._with(self.storage.push_dense(delta_dense))

    def push_prefix(self, delta: torch.Tensor) -> "MatrixHandle":
        """Push a dense delta covering the first ``delta.shape[0]`` logical
        rows (the hybrid's hot-word buffer)."""
        return self._with(self.storage.push_prefix(delta))

    def push_rows(self, rows: torch.Tensor,
                  deltas: torch.Tensor) -> "MatrixHandle":
        """Push row deltas to logical rows (duplicates accumulate)."""
        return self._with(self.storage.push(rows, deltas))

    def push_coo(self, rows: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor) -> "MatrixHandle":
        """Push compressed ``(row, col, +-value)`` coordinate deltas.

        Guards the storage layer's padding-row invariant here, in the
        client: logical row ids ``>= num_rows`` (padded buffers, or ids that
        would alias a real row under the cyclic map) become value-0
        no-ops before ``DistributedMatrix.push_sparse`` sees them.
        """
        keep = rows < self.num_rows
        vals = torch.where(keep, vals, torch.zeros_like(vals))
        rows = torch.where(keep, rows, torch.zeros_like(rows))
        return self._with(self.storage.push_sparse(rows, cols, vals))

    def store_block(self, block, rows: torch.Tensor,
                    rows_per_block: int) -> "MatrixHandle":
        """Write back a physical block pulled by its exclusive owner
        (``rows`` replaces the block), into a copy of the table."""
        return self.with_value(self.value.clone()).store_block_(
            block, rows, rows_per_block)

    def store_block_(self, block, rows: torch.Tensor,
                     rows_per_block: int) -> "MatrixHandle":
        """``store_block`` in place, for an executor that owns this
        handle's tensor: the group-boundary merge of the pipelined
        executor.  Legal because blocks own disjoint physical rows."""
        start = self.storage.block_start(block, rows_per_block)
        self.value[start:start + rows_per_block] = rows.to(self.value.dtype)
        return self

    def push_block(self, block, delta_rows: torch.Tensor,
                   rows_per_block: int) -> "MatrixHandle":
        """Additive push of a [rows_per_block, cols] delta to one physical
        block."""
        cur = self.storage.pull_block(block, rows_per_block)
        return self.store_block(block, cur + delta_rows.to(cur.dtype),
                                rows_per_block)

    # --- backend moments --------------------------------------------------
    def localize(self) -> "MatrixHandle":
        """Keep only this server shard's rows."""
        return self._with(self.client.backend.localize(self.storage))

    # --- serving ----------------------------------------------------------
    def read_view(self) -> "ReadOnlyView":
        """Read-only snapshot view of this handle (serving side)."""
        return ReadOnlyView(self)


@dataclasses.dataclass(frozen=True)
class VectorHandle:
    """Client handle for one distributed vector (Glint's ``BigVector``);
    for LDA it holds ``n_k``, replicated."""

    storage: DistributedVector
    client: "PSClient"

    @property
    def value(self) -> torch.Tensor:
        return self.storage.value

    def with_value(self, value: torch.Tensor) -> "VectorHandle":
        return dataclasses.replace(self, storage=DistributedVector(value))

    def pull(self, idx: torch.Tensor) -> PullHandle:
        return PullHandle(self.storage.pull(idx))

    def pull_all(self) -> PullHandle:
        return PullHandle(self.storage.value.clone())

    def push(self, idx: torch.Tensor,
             deltas: torch.Tensor) -> "VectorHandle":
        return dataclasses.replace(self, storage=self.storage.push(idx,
                                                                   deltas))

    def push_dense(self, delta: torch.Tensor) -> "VectorHandle":
        """Push a dense delta, reduced exactly once over workers."""
        delta = self.client.backend.reduce(delta)
        return dataclasses.replace(self,
                                   storage=self.storage.push_dense(delta))


@dataclasses.dataclass(frozen=True)
class ReadOnlyView:
    """Read-only snapshot view of a ``MatrixHandle``: pulls only.  A push
    through a view is a programming error and raises."""

    handle: MatrixHandle

    @property
    def num_rows(self) -> int:
        return self.handle.num_rows

    @property
    def cols(self) -> int:
        return self.handle.cols

    def pull(self, rows: torch.Tensor) -> PullHandle:
        return self.handle.pull(rows)

    def pull_block(self, block, rows_per_block: int) -> PullHandle:
        return self.handle.pull_block(block, rows_per_block)

    def to_dense(self) -> torch.Tensor:
        return self.handle.pull_all().result()

    def push(self, *a, **k):
        raise TypeError("ReadOnlyView is read-only: serving snapshots "
                        "never push (publish from the training handle)")

    push_dense = push_coo = store_block = store_block_ = push_rows = push


@dataclasses.dataclass(frozen=True)
class PSClient:
    """The parameter-server client factory (Glint's ``Client``).
    ``backend`` supplies the collectives; ``num_shards`` the cyclic server
    count of every matrix it makes."""

    backend: Backend = InProcessBackend()
    num_shards: int = 1

    @classmethod
    def create(cls, num_shards: int = 1, *,
               backend: Union[str, Backend, None] = None,
               mesh=None, axis_name=None,
               model_axis: Optional[str] = None,
               server: Optional[str] = None) -> "PSClient":
        """Build a client.  ``backend`` is a name (``"in_process"``,
        ``"spmd"``, ``"tiered"``, ``"net"``) or a ``Backend`` instance.
        ``backend=None`` infers as the JAX package does: no mesh/axes means
        in-process, any of ``mesh`` / ``axis_name`` / ``model_axis`` means
        ``SpmdBackend`` -- ``axis_name`` defaults to both of the mesh's
        axes (every rank is a worker), ``model_axis`` names the server
        axis holding the cyclic ``n_wk`` rows; ``mesh`` is the
        ``launch.mesh.Mesh`` its collectives run on.
        ``backend="net"`` with ``server="host:port"`` connects a
        ``NetClient`` to a running parameter server (either package's
        ``launch.ps_server``); without ``server`` the net backend is
        detached."""
        if isinstance(backend, str):
            backend = cls._backend_by_name(backend, server=server, mesh=mesh,
                                           axis_name=axis_name,
                                           model_axis=model_axis)
        elif backend is None:
            if mesh is None and axis_name is None and model_axis is None:
                backend = InProcessBackend()
            else:
                backend = cls._spmd_backend(mesh, axis_name, model_axis)
        elif not isinstance(backend, Backend):
            raise BackendConfigError(
                f"backend must be a name or a ps.Backend instance "
                f"(got {type(backend).__name__})")
        return cls(backend=backend, num_shards=num_shards)

    @staticmethod
    def _spmd_backend(mesh, axis_name, model_axis) -> SpmdBackend:
        if axis_name is None and mesh is not None:
            axis_name = ("data", "model")
        if isinstance(axis_name, list):
            axis_name = tuple(axis_name)
        return SpmdBackend(axis_name=axis_name, model_axis=model_axis,
                           mesh=mesh)

    @classmethod
    def _backend_by_name(cls, name: str, *, server, mesh, axis_name,
                         model_axis) -> Backend:
        if name == "in_process":
            return InProcessBackend()
        if name == "spmd":
            if mesh is None and axis_name is None:
                raise BackendConfigError(
                    "backend='spmd' needs mesh= or axis_name= (the "
                    "shard_map axes the collectives run over)")
            return cls._spmd_backend(mesh, axis_name, model_axis)
        if name == "tiered":
            from repro_torch.ps.tiered import TieredBackend
            return TieredBackend()
        if name == "net":
            from repro_torch.ps.net import NetBackend, NetClient
            return NetBackend(
                net=NetClient.connect(server) if server else None)
        raise BackendConfigError(f"unknown backend {name!r}")

    def with_backend(self, backend: Backend) -> "PSClient":
        return dataclasses.replace(self, backend=backend)

    # --- matrix factories -------------------------------------------------
    def matrix(self, rows: int, cols: int, dtype=torch.int32, *,
               route: PushRoute = DenseRoute(),
               device: Device = None) -> MatrixHandle:
        """A zeroed [rows, cols] distributed matrix on ``device`` (the card
        unless the caller asks for another)."""
        return MatrixHandle(
            DistributedMatrix.zeros(rows, cols, self.num_shards, dtype,
                                    device=resolve_device(device)),
            self, route)

    def matrix_from_dense(self, dense: torch.Tensor, *,
                          route: PushRoute = DenseRoute()) -> MatrixHandle:
        """Wrap a dense logical matrix (rows placed cyclically; copied)."""
        return MatrixHandle(DistributedMatrix.from_dense(dense,
                                                         self.num_shards),
                            self, route)

    def wrap_matrix(self, value: Union[torch.Tensor, DistributedMatrix],
                    num_rows: Optional[int] = None, *,
                    route: PushRoute = DenseRoute()) -> MatrixHandle:
        """Adopt existing physical (cyclic-ordered) storage: a
        ``DistributedMatrix``, or a raw physical tensor with ``num_rows``."""
        if isinstance(value, DistributedMatrix):
            storage = value
        else:
            if num_rows is None:
                raise ValueError("num_rows is required for a raw tensor")
            storage = DistributedMatrix(value, num_rows, self.num_shards)
        return MatrixHandle(storage, self, route)

    def tiered_matrix_from_dense(self, dense, hot_rows: int, path: str, *,
                                 route: PushRoute = DenseRoute(),
                                 device: Device = None):
        """Wrap a dense logical matrix in tiered storage: the full table
        lands in a host memmap cold store at ``path`` and the top
        ``hot_rows`` rows are promoted into a hot tier on ``device`` (the
        card unless the caller passes another; ``repro_torch.ps.tiered``).
        Single-shard only -- the tiered store is the in-process scale-up
        axis."""
        from repro_torch.ps.tiered import tiered_matrix_from_dense
        if self.num_shards != 1:
            raise ValueError(f"tiered storage is single-shard (this client "
                             f"has {self.num_shards} shards)")
        return tiered_matrix_from_dense(dense, hot_rows, path, route=route,
                                        client=self, device=device)

    # --- vector factories -------------------------------------------------
    def vector(self, n: int, dtype=torch.int32, *,
               device: Device = None) -> VectorHandle:
        return VectorHandle(DistributedVector.zeros(
            n, dtype, device=resolve_device(device)), self)

    def wrap_vector(self, value: Union[torch.Tensor, DistributedVector]
                    ) -> VectorHandle:
        if not isinstance(value, DistributedVector):
            value = DistributedVector(value)
        return VectorHandle(value, self)


def client_for(cfg, *, mesh=None, axis_name=None,
               model_axis: Optional[str] = None) -> PSClient:
    """Client matching an ``LDAConfig`` (its shard count); mesh/axes as in
    ``PSClient.create``."""
    return PSClient.create(num_shards=cfg.num_shards, mesh=mesh,
                           axis_name=axis_name, model_axis=model_axis)
