"""Glint-style parameter-server client layer (paper section 2).

The one gateway to the distributed count tables:

  client  = PSClient.create(...)            # in-process backend
  nwk     = client.matrix(V, K)             # MatrixHandle (Glint BigMatrix)
  fut     = nwk.pull_block(b, rpb)          # PullHandle future: issue ...
  rows    = fut.result()                    # ... overlap ... await
  nwk     = nwk.push(reassign)              # routed via the handle's PushRoute

Routes (``DenseRoute`` / ``CooRoute`` / ``HybridRoute``) make the paper's
section-3.3 hybrid push a declarative policy; backends
(``InProcessBackend`` / ``SpmdBackend`` / ``TieredBackend`` /
``NetBackend``) swap the collectives -- and, for the tiered backend, the storage substrate itself (a
device hot-row cache over a host memmap cold tier, ``ps.tiered``); for the
network backend a standalone server process (``ps.net``) -- without
touching call sites.  ``ps.autotune`` measures routes and staleness bounds.
``core/pserver.py`` is the storage layer underneath.
"""
from repro_torch.ps.backend import Backend, InProcessBackend, SpmdBackend
from repro_torch.ps.client import (BACKEND_NAMES, BackendConfigError,
                                   MatrixHandle, PSClient, PullHandle,
                                   ReadOnlyView, VectorHandle, client_for)
from repro_torch.ps.coldstore import ColdStore
from repro_torch.ps.routes import (CooRoute, DenseRoute, HybridRoute,
                                   PushRoute, Reassign, RouteDelta,
                                   partition_by_mask, partition_reassign,
                                   route_for)
from repro_torch.ps.tiered import (TieredBackend, TieredMatrix,
                                   TieredMatrixHandle, TierStats,
                                   tiered_matrix_from_dense)
from repro_torch.ps import autotune
from repro_torch.ps import net
from repro_torch.ps.net import NetBackend, NetClient, NetMatrixHandle

__all__ = [
    "Backend", "InProcessBackend", "SpmdBackend", "TieredBackend",
    "MatrixHandle", "PSClient", "PullHandle", "ReadOnlyView",
    "VectorHandle", "client_for",
    "ColdStore", "TieredMatrix", "TieredMatrixHandle", "TierStats",
    "tiered_matrix_from_dense",
    "CooRoute", "DenseRoute", "HybridRoute", "PushRoute", "Reassign",
    "RouteDelta", "partition_by_mask", "partition_reassign", "route_for",
    "autotune", "net", "NetBackend", "NetClient", "NetMatrixHandle",
    "BACKEND_NAMES", "BackendConfigError",
]
