"""Topic-model serving facade: train -> snapshot -> serve in one object.

``TopicService`` owns the three pieces of the serving path and wires them
to a training state on one device (the card unless the caller passes
``device="cpu"``):

  * the training session (``repro_torch.api.session``) keeps improving the
    model counts -- the *same* executor spec (``ExecConfig``: staleness,
    model blocks, push route) the LDA launcher uses;
  * a ``SnapshotPublisher`` periodically freezes (n_wk, n_k) into an
    immutable versioned snapshot (alias tables built once per version) --
    either the service's own, or one handed in from outside (e.g.
    ``repro_torch.api.TopicModel.publisher()``, the estimator-to-serving
    handoff);
  * a ``QueryEngine`` folds in unseen documents against the latest
    snapshot and scores queries with topic-smoothed query likelihood.

Under production traffic the service runs *concurrently*:
``start_serving()`` attaches a ``ConcurrentEngine`` -- thread-safe
admission, latency-bounded dynamic batching, typed deadline shedding --
and ``train_async()`` keeps training on a background thread while
``PublishCallback`` hands a fresh snapshot to the live engine every N
visits (zero-downtime refresh with bounded, measured staleness).  Both
threads launch work on the one device; a published snapshot is built from
a pulled copy of the counts and synchronised before the swap, and a sweep
never writes into the tables it was given, so serving never reads a table
that training is writing.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import rng as jrng
from repro_torch.core import lightlda as lda
from repro_torch.device import Device, resolve_device
from repro_torch.infer.engine import (ConcurrentEngine, EngineConfig,
                                      QueryEngine, Result, Ticket)
from repro_torch.infer.snapshot import Snapshot, SnapshotPublisher
from repro_torch.train.async_exec import ExecConfig


class TrainingHandle:
    """Join handle for a background ``train_async`` run.

    ``join()`` blocks until the training thread finishes and returns the
    final published snapshot (re-raising any training error on the
    caller's thread, so failures in the continuous-learning loop never
    pass silently).
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._snapshot: Optional[Snapshot] = None
        self._error: Optional[BaseException] = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> Snapshot:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"training still running after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._snapshot


@dataclasses.dataclass
class TopicService:
    """``exec_cfg`` is the full training spec (``staleness`` /
    ``model_blocks`` / ``route`` -- ``train.async_exec.ExecConfig``),
    identical to what the launcher passes.  ``publisher`` adopts an
    external ``SnapshotPublisher`` (e.g. ``TopicModel.publisher()``)
    instead of starting empty.  ``device`` is where training runs and the
    service's own snapshots live: the card unless the caller passes
    another."""

    cfg: lda.LDAConfig
    ecfg: EngineConfig = EngineConfig()
    state: Optional[lda.SamplerState] = None
    exec_cfg: ExecConfig = ExecConfig()
    publisher: Optional[SnapshotPublisher] = None
    device: Device = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.publisher is None:
            self.publisher = SnapshotPublisher(self.cfg)
        self.engine = QueryEngine(self.publisher, self.ecfg)
        self._serving: Optional[ConcurrentEngine] = None

    # -- training side ---------------------------------------------------
    def init_from_corpus(self, corp, seed: int = 0) -> None:
        dev = self.device
        self.state = lda.init_state(
            jrng.PRNGKey(seed, dev), torch.from_numpy(corp.w).to(dev),
            torch.from_numpy(corp.d).to(dev), corp.num_docs, self.cfg)

    def train(self, num_sweeps: int, key: torch.Tensor,
              publish_every: int = 0) -> Snapshot:
        """Run training sweeps through the session's memory plane; publish
        every ``publish_every`` sweeps (and always once at the end).
        Returns the final snapshot."""
        assert self.state is not None, "init_from_corpus / set state first"
        from repro_torch.api.callbacks import PublishCallback
        from repro_torch.api.session import memory_fit

        cbs = ([PublishCallback(self.publisher, every=publish_every)]
               if publish_every else [])
        with _obs.span("service.train", cat="serve", sweeps=num_sweeps,
                       publish_every=publish_every):
            state, _, _ = memory_fit(
                self.state, key.to(self.device), self.cfg, self.exec_cfg,
                num_sweeps, eval_every=0, log_fn=lambda *a, **k: None,
                callbacks=cbs)
            self.state = state
            return self.publisher.publish_state(state)

    def train_async(self, num_sweeps: int, key: torch.Tensor,
                    publish_every: int = 1) -> TrainingHandle:
        """Continuous-learning mode: run ``train`` on a background thread,
        publishing every ``publish_every`` sweeps while the live engine
        keeps serving.  Each published version is picked up by the next
        dynamic batch -- zero-downtime refresh -- and the
        ``serve.version_lag`` gauge measures how far serving ever trails
        the newest publication.  Returns a ``TrainingHandle``; ``join()``
        yields the final snapshot."""
        handle = TrainingHandle()

        def _run():
            try:
                handle._snapshot = self.train(num_sweeps, key,
                                              publish_every=publish_every)
            except BaseException as exc:   # noqa: BLE001 -- re-raised at join
                handle._error = exc

        handle._thread = threading.Thread(
            target=_run, name="repro-serve-trainer", daemon=True)
        handle._thread.start()
        return handle

    # -- concurrent serving ------------------------------------------------
    def start_serving(self, max_delay_ms: Optional[float] = None,
                      deadline_ms: Optional[float] = None
                      ) -> ConcurrentEngine:
        """Attach and start the concurrent admission plane.  ``submit()``
        becomes available from any thread; batching/deadline knobs
        default to ``ecfg.max_delay_ms`` / ``ecfg.deadline_ms``."""
        if self._serving is not None:
            raise RuntimeError("already serving; stop_serving() first")
        self._serving = ConcurrentEngine(
            self.engine, max_delay_ms=max_delay_ms,
            deadline_ms=deadline_ms).start()
        return self._serving

    def submit(self, tokens: Sequence[int], seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> Ticket:
        """Admit one document to the live batcher; returns a waitable
        ``Ticket`` (``result()`` -> ``Result`` or ``DeadlineExceeded``)."""
        if self._serving is None:
            raise RuntimeError("not serving; start_serving() first")
        return self._serving.submit(tokens, seed=seed,
                                    deadline_ms=deadline_ms)

    def stop_serving(self, drain: bool = True) -> None:
        """Stop the batcher (``drain=True``: serve the queued remainder
        first).  Idempotent."""
        if self._serving is not None:
            self._serving.close(drain=drain)
            self._serving = None

    @property
    def serving(self) -> Optional[ConcurrentEngine]:
        """The live admission plane, or None when not started."""
        return self._serving

    # -- serving side ----------------------------------------------------
    def fold_in(self, docs: Sequence[np.ndarray],
                seeds: Optional[Sequence[int]] = None) -> List[Result]:
        """θ for a batch of unseen documents (bucketed + batched)."""
        with _obs.span("service.fold_in", cat="serve", docs=len(docs),
                       version=self.version):
            return self.engine.infer(docs, seeds)

    def score(self, queries: Sequence[np.ndarray],
              docs: Sequence[np.ndarray],
              results: Optional[Sequence[Result]] = None) -> np.ndarray:
        """Rank ``docs`` for ``queries``: [num_queries, num_docs] log p(q|d).

        ``results`` reuses already-computed fold-ins; otherwise the docs are
        folded in first.
        """
        if results is None:
            results = self.fold_in(docs)
        with _obs.span("service.score", cat="serve", queries=len(queries),
                       docs=len(docs)):
            return self.engine.score(results, docs, queries)

    @property
    def version(self) -> int:
        return self.publisher.version
