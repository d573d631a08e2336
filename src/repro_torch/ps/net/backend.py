"""``NetBackend`` -- the third ``Backend``: parameters live in a
``PSServer`` process and every pull/push crosses the wire.

The merge point is the server itself (plain integer adds under its lock),
so from the worker's point of view the protocol moments are identities --
exactly like ``InProcessBackend`` -- and the network I/O happens at the
*handle* boundary: ``NetMatrixHandle.push`` plans the route locally (the
same ``PushRoute`` plan the in-process handle applies) and ships the
plan's two halves as the wire's two push ops, ``push_dense_prefix`` for
the prefix-dense part and ``push_coo`` for the coordinate part.  Because
both sides apply the same integer adds, any route is bitwise identical to
the in-process handle.

Pulls arrive as numpy int32 off the wire and land in tensors on the
handle's device (the card unless the caller asks for another); pushes
copy their tensors to the host for the wire.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.ps.net import wire
from repro_torch.ps.net.transport import NetClient
from repro_torch.ps.routes import DenseRoute, PushRoute, Reassign


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class NetBackend:
    """Backend whose authoritative storage is a remote ``PSServer``.

    ``net=None`` is a detached backend (structural conformance only);
    with a connected ``NetClient``, ``pull_full`` refreshes the local
    mirror from the server onto the mirror's device.
    ``reduce``/``gather_concat``/``localize`` are identities: worker
    contributions merge server-side.
    """

    net: Optional[NetClient] = None
    axis_name = None
    model_axis = None

    def pull_full(self, storage):
        if self.net is None:
            return storage
        from repro_torch.core.pserver import DistributedMatrix
        dense = torch.from_numpy(self.net.pull_full(wire.MAT_NWK))
        return DistributedMatrix.from_dense(dense.to(storage.value.device),
                                            storage.num_shards)

    def reduce(self, delta: torch.Tensor) -> torch.Tensor:
        return delta

    def gather_concat(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def localize(self, full):
        return full


class NetMatrixHandle:
    """Client handle for the server-resident ``[V, K]`` table.

    Duck-types the read/push surface of ``ps.MatrixHandle``: pulls return
    ``PullHandle`` futures over freshly fetched rows on ``device``, pushes
    plan through the handle's ``PushRoute`` and ship the plan over the
    wire.  Pushes mutate the *server*; the handle itself stays stateless,
    so "push then pull" reads back the merged global state -- the network
    analogue of the functional in-process update.
    """

    def __init__(self, net: NetClient, num_rows: int, cols: int, *,
                 route: PushRoute = DenseRoute(), device: Device = None):
        self.net = net
        self.num_rows = int(num_rows)
        self.cols = int(cols)
        self.route = route
        self.device = resolve_device(device)

    def _tensor(self, arr: np.ndarray):
        from repro_torch.ps.client import PullHandle
        return PullHandle(torch.from_numpy(arr).to(self.device))

    # -- pulls ---------------------------------------------------------------
    def pull_all(self):
        return self._tensor(self.net.pull_full(wire.MAT_NWK))

    def pull_block(self, block: int, rows_per_block: int):
        start = block * rows_per_block
        nrows = min(rows_per_block, self.num_rows - start)
        return self._tensor(self.net.pull_block(wire.MAT_NWK, start, nrows))

    def to_dense(self) -> torch.Tensor:
        return self.pull_all().result()

    # -- pushes --------------------------------------------------------------
    def push(self, re: Reassign, *,
             hot_prefix: Optional[int] = None) -> "NetMatrixHandle":
        plan = self.route.plan(re, self.num_rows, self.cols,
                               prefix_rows=True, hot_prefix=hot_prefix)
        if plan.dense is not None:
            self.net.push_dense_prefix(wire.MAT_NWK, _np(plan.dense),
                                       start=0)
        if plan.coo is not None:
            rows, cols, vals = (_np(x) for x in plan.coo)
            self.net.push_coo(wire.MAT_NWK, rows, cols, vals)
        return self

    def push_dense(self, delta) -> "NetMatrixHandle":
        self.net.push_dense_prefix(wire.MAT_NWK, _np(delta), start=0)
        return self

    push_prefix = push_dense

    def push_coo(self, rows, cols, vals, **_) -> "NetMatrixHandle":
        self.net.push_coo(wire.MAT_NWK, _np(rows), _np(cols), _np(vals))
        return self


class NetVectorHandle:
    """Client handle for the server-resident ``[K]`` topic totals."""

    def __init__(self, net: NetClient, n: int, *, device: Device = None):
        self.net = net
        self.n = int(n)
        self.device = resolve_device(device)

    def pull_all(self):
        from repro_torch.ps.client import PullHandle
        return PullHandle(torch.from_numpy(
            self.net.pull_full(wire.MAT_NK)).to(self.device))

    @property
    def value(self) -> torch.Tensor:
        return self.pull_all().result()

    def push_dense(self, delta) -> "NetVectorHandle":
        self.net.push_dense_prefix(wire.MAT_NK, _np(delta), start=0)
        return self

    def push(self, idx, deltas) -> "NetVectorHandle":
        idx = _np(idx).astype(wire.I4)
        self.net.push_coo(wire.MAT_NK, idx, np.zeros_like(idx),
                          _np(deltas))
        return self
