"""Topic inference serving subsystem.

  foldin    -- batched MH fold-in of unseen documents against a frozen
               (n_wk, n_k) snapshot (amortised-O(1) sampling via the
               snapshot's alias tables; one ``mh_sample`` launch a sweep);
  snapshot  -- double-buffered snapshot publication (monotonic versions,
               bounded staleness; one ``alias_build`` launch a publish);
  engine    -- request queue with padding-bucket batching returning per-doc
               topic vectors θ plus topic-smoothed query-likelihood scores;
               synchronous (``QueryEngine``) and concurrent
               (``ConcurrentEngine``: admission tickets, dual-trigger
               dynamic batching, deadline load-shedding).
"""
from repro_torch.infer.foldin import FoldInConfig, fold_in_batch, pack_docs
from repro_torch.infer.snapshot import Snapshot, SnapshotPublisher
from repro_torch.infer.engine import (ConcurrentEngine, DeadlineExceeded,
                                      EngineConfig, QueryEngine, Ticket)

__all__ = [
    "FoldInConfig", "fold_in_batch", "pack_docs",
    "Snapshot", "SnapshotPublisher",
    "ConcurrentEngine", "DeadlineExceeded", "EngineConfig", "QueryEngine",
    "Ticket",
]
