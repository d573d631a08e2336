"""Network parameter server: the PS as a standalone process.

The paper runs workers and parameter servers as independent processes
joined only by an RPC key-value interface (section 2.1, Glint);
``repro_torch.ps.net`` is that plane: a TCP server hosting the count
tables (``server``), a fault-tolerant exactly-once client transport
(``transport``), the third ``Backend`` + net-backed handles (``backend``),
the worker loop (``worker``, its sweep on the card) and the elastic
localhost pool (``pool``).  Wire format and op codes live in ``wire``,
frame for frame the JAX package's, so either package's workers and
servers talk to each other; DESIGN.md section 15 is the spec.
"""
from repro_torch.ps.net import wire
from repro_torch.ps.net.backend import (NetBackend, NetMatrixHandle,
                                        NetVectorHandle)
from repro_torch.ps.net.server import PSServer, TableStore
from repro_torch.ps.net.transport import (FaultInjector, NetClient,
                                          ServerError, Transport,
                                          TransportConfig, TransportError)

__all__ = [
    "wire", "PSServer", "TableStore",
    "Transport", "TransportConfig", "TransportError", "ServerError",
    "FaultInjector", "NetClient",
    "NetBackend", "NetMatrixHandle", "NetVectorHandle",
    "WorkerConfig", "run_worker", "WorkerPool",
]


def __getattr__(name):
    # the worker and the pool load on first use: ``python -m
    # repro_torch.ps.net.worker`` must not find its module imported by the
    # package before it runs
    if name in ("WorkerConfig", "run_worker"):
        from repro_torch.ps.net import worker
        return getattr(worker, name)
    if name == "WorkerPool":
        from repro_torch.ps.net.pool import WorkerPool
        return WorkerPool
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
