"""Callbacks of the trainer: observers of a run, never participants.

The ``Session`` loop invokes them after each executor visit has produced
the new state, hands them a read-only ``SweepView``, and consumes nothing
from them; no callback reaches the random stream, the schedule, or the
state that feeds the next visit (a sweep never writes into the state it
was given, so a view stays what it was).  ``APSLDA.fit`` with callbacks is
bitwise identical to a run without.

Built-ins:

  * ``EvalCallback``        training (and optionally held-out fold-in)
                            perplexity and coherence on a cadence; keeps
                            the ``history`` rows;
  * ``CheckpointCallback``  persists the run every N visits and at the end;
  * ``LogCallback``         structured JSONL event log (one object per
                            line: fit_start / sweep / fit_end);
  * ``PublishCallback``     the continuous-learning handoff: publishes a
                            serving snapshot through a
                            ``SnapshotPublisher`` every N visits while the
                            engine keeps serving;
  * ``TraceCallback``       attaches the ``repro_torch.obs`` telemetry
                            plane to one fit (per-visit spans, a
                            ``tokens_seen`` counter series).
"""
from __future__ import annotations

import json
import time
from typing import IO, Optional, Union

import numpy as np

from repro_torch import obs as _obs


class SweepView:
    """Read-only observation of one completed executor visit.

    ``step`` is the 1-based global visit counter (sweeps in memory mode,
    shard visits in stream mode); ``epoch``/``pos`` locate the visit in
    the schedule; ``shard_id`` is the on-disk shard for streamed sources
    (None in memory mode).  ``state`` is the post-visit sampler state
    where the plane has one; ``nwk``/``nk`` are always
    the current PS handles.  All helpers delegate to the session's data
    plane -- callbacks stay plane-agnostic.
    """

    def __init__(self, plane, *, step: int, epoch: int, pos: int,
                 shard_id: Optional[int], is_last: bool, state, nwk, nk,
                 tokens_seen: int, cursor_next=None):
        self._plane = plane
        self.step = step
        self.epoch = epoch
        self.pos = pos
        self.shard_id = shard_id
        self.is_last = is_last
        self.state = state
        self.nwk = nwk
        self.nk = nk
        self.tokens_seen = tokens_seen
        self.cursor_next = cursor_next

    # -- observation helpers (pure reads) --------------------------------
    def sync(self) -> None:
        """Block until this visit's device work is complete (so elapsed
        times measure finished work, exactly as the old host loops did)."""
        self._plane.sync(self)

    @property
    def elapsed_s(self) -> float:
        return time.time() - self._plane.t0

    def perplexity(self) -> float:
        """Training perplexity of the current state (plane-specific
        layout handled by the plane)."""
        return self._plane.perplexity(self)

    def history_row(self, perplexity: float) -> dict:
        """The plane's canonical history row for this visit (the format
        the pre-redesign host loops emitted, kept stable)."""
        return self._plane.history_row(self, perplexity)

    def log_line(self, perplexity: float) -> str:
        return self._plane.log_line(self, perplexity)

    # -- persistence (observation of state, never mutation of it) --------
    def save(self, path: str) -> None:
        """Checkpoint the run as of this visit (``save_lda`` for the memory
        plane, ``save_stream`` + the stream's z files for the stream
        plane)."""
        self._plane.checkpoint(self, path)

    def __repr__(self):
        where = (f"epoch {self.epoch} pos {self.pos}"
                 + (f" shard {self.shard_id}" if self.shard_id is not None
                    else ""))
        return f"SweepView(step={self.step}, {where})"


class Callback:
    """Base observer.  Subclasses override any subset; every hook is a
    pure observation -- writing into the training state from a callback
    is a contract violation."""

    def on_fit_start(self, info: dict) -> None:
        """Called once, after the executor is built; ``info`` is the
        realised-schedule description (mode, blocks, staleness, route)."""

    def on_sweep_end(self, view: SweepView) -> None:
        """Called after every executor visit."""

    def on_fit_end(self, view: Optional[SweepView]) -> None:
        """Called once after the last visit (``view`` is the final
        visit's view, or a terminal view when the schedule was empty)."""


class EvalCallback(Callback):
    """Perplexity (and optional NPMI coherence) on a cadence.

    ``every`` counts visits (0: never); ``include_last`` additionally
    evaluates the final visit (the old in-memory trainer's behaviour).
    ``heldout`` is an optional ``data.corpus.Corpus`` of held-out
    documents scored by fold-in perplexity against the current counts --
    the estimator-level view of the serving path's quality.  Rows
    accumulate in ``.history``; evaluation only ever *reads* the state.
    """

    def __init__(self, every: int = 10, *, include_last: bool = True,
                 heldout=None, coherence: bool = False, log_fn=None):
        self.every = int(every)
        self.include_last = include_last
        self.heldout = heldout
        self.coherence = coherence
        self.log_fn = log_fn
        self.history: list = []
        self._last_step = 0

    def _due(self, view: SweepView) -> bool:
        # fire on *crossing* a multiple of ``every``: identical to
        # ``step % every == 0`` when steps advance by 1, and the right
        # cadence when a plane advances several visits per sweep (the
        # streamed SPMD plane consumes ``workers`` shards at a time)
        last, self._last_step = self._last_step, view.step
        if self.every and view.step // self.every > last // self.every:
            return True
        return bool(self.include_last and view.is_last and
                    (self.every or self.heldout is not None))

    def on_sweep_end(self, view: SweepView) -> None:
        if not self._due(view):
            return
        view.sync()
        p = view.perplexity()
        row = view.history_row(p)
        if self.heldout is not None:
            row["heldout_perplexity"] = self._heldout_perplexity(view)
        if self.coherence:
            row["coherence"] = self._coherence(view)
        self.history.append(row)
        if self.log_fn is not None:
            self.log_fn(view.log_line(p))

    # -- optional extras (pure reads of the count tables) ----------------
    def _heldout_perplexity(self, view: SweepView) -> float:
        import torch
        from repro_torch.core import perplexity as ppl
        from repro_torch.data import corpus as corpus_mod

        cfg = self._plane_cfg(view)
        dense = view.nwk.to_dense()
        phi = ppl.phi_from_counts(
            dense.to(torch.float32),
            view.nk.pull_all().result().to(torch.float32), cfg.beta)
        w, d, fold, ev = (torch.from_numpy(np.asarray(x)).to(dense.device)
                          for x in corpus_mod.fold_eval_split(self.heldout))
        return float(ppl.heldout_perplexity(
            w, d, fold, w, d, ev, phi, self.heldout.num_docs, cfg.alpha))

    def _coherence(self, view: SweepView) -> float:
        import torch
        from repro_torch.core import coherence as coh
        from repro_torch.core import perplexity as ppl

        cfg = self._plane_cfg(view)
        ref = self.heldout
        if ref is None:
            return float("nan")
        phi = ppl.phi_from_counts(
            view.nwk.to_dense().to(torch.float32),
            view.nk.pull_all().result().to(torch.float32),
            cfg.beta).cpu().numpy()
        return float(coh.mean_coherence(phi, np.asarray(ref.w),
                                        np.asarray(ref.d), cfg.V,
                                        ref.num_docs))

    @staticmethod
    def _plane_cfg(view: SweepView):
        return view._plane.cfg


class CheckpointCallback(Callback):
    """Persist the run every ``every`` visits and once at the end.

    With ``every=0`` only the end-of-fit checkpoint is written.
    Checkpointing reads the state and writes to disk -- it never touches
    the run.
    """

    def __init__(self, path: str, every: int = 0):
        if not path:
            raise ValueError("CheckpointCallback needs a path")
        self.path = path
        self.every = int(every)
        self._last_step = 0

    def on_sweep_end(self, view: SweepView) -> None:
        # crossing-based cadence, same rationale as EvalCallback._due
        last, self._last_step = self._last_step, view.step
        if self.every and view.step // self.every > last // self.every:
            view.save(self.path)

    def on_fit_end(self, view: Optional[SweepView]) -> None:
        if view is not None:
            view.save(self.path)


class LogCallback(Callback):
    """Structured JSONL event history (one JSON object per line).

    ``sink`` is a path (appended to) or an open file-like object.  Events:
    ``fit_start`` (the executor's realised schedule), ``sweep`` (one per
    visit: step/epoch/pos/shard/elapsed/tokens), ``fit_end``.

    Every line carries both clocks -- ``t_wall`` (``time.time``, for
    correlating with external systems) and ``t_mono``
    (``time.monotonic``, for robust intervals) -- and is flushed as it is
    written, so a killed run keeps a complete log up to its last event.
    """

    def __init__(self, sink: Union[str, IO], every: int = 1):
        self._path: Optional[str] = sink if isinstance(sink, str) else None
        self._file: Optional[IO] = None if isinstance(sink, str) else sink
        self.every = max(1, int(every))
        self._steps = 0

    def _emit(self, obj: dict) -> None:
        line = json.dumps(dict(obj, t_wall=time.time(),
                               t_mono=time.monotonic()), sort_keys=True)
        if self._path is not None:
            # open/append/close per event: durable even on SIGKILL
            with open(self._path, "a") as f:
                f.write(line + "\n")
        else:
            self._file.write(line + "\n")
            self._file.flush()

    def on_fit_start(self, info: dict) -> None:
        self._emit({"event": "fit_start",
                    **{k: v for k, v in info.items()
                       if isinstance(v, (int, float, str, bool,
                                         type(None)))}})

    def on_sweep_end(self, view: SweepView) -> None:
        self._steps = view.step
        if view.step % self.every:
            return
        self._emit({"event": "sweep", "step": view.step,
                    "epoch": view.epoch, "pos": view.pos,
                    "shard": view.shard_id, "elapsed_s": view.elapsed_s,
                    "tokens_seen": view.tokens_seen})

    def on_fit_end(self, view: Optional[SweepView]) -> None:
        self._emit({"event": "fit_end", "steps": self._steps})


class PublishCallback(Callback):
    """Publish a serving snapshot every ``every`` executor visits.

    The continuous-learning handoff: a training fit keeps sweeping while
    this callback periodically freezes the current counts into the given
    ``SnapshotPublisher``; a live ``ConcurrentEngine`` reading that
    publisher picks the new version up at its next batch -- zero-downtime
    refresh, with staleness bounded by the publish cadence.

    Publication is a pure *read* of the training handles (``publish_view``
    over ``nwk.read_view()`` + ``nk``): the publisher builds its snapshot
    from a pulled copy and synchronises before the swap, and a sweep never
    writes into the tables it was given, so the trained model is bitwise
    identical with or without it attached.  ``every`` counts visits
    (sweeps in memory mode, shard visits in stream mode) on the same
    crossing-based cadence as ``EvalCallback``; ``include_last``
    additionally publishes the final visit.  Published version numbers
    accumulate in ``.versions``.
    """

    def __init__(self, publisher, every: int = 1, *,
                 include_last: bool = False):
        if publisher is None:
            raise ValueError("PublishCallback needs a SnapshotPublisher")
        self.publisher = publisher
        self.every = int(every)
        self.include_last = include_last
        self.versions: list = []
        self._last_step = 0

    def _publish(self, view: SweepView) -> None:
        view.sync()
        snap = self.publisher.publish_view(view.nwk.read_view(), view.nk)
        self.versions.append(snap.version)

    def on_sweep_end(self, view: SweepView) -> None:
        last, self._last_step = self._last_step, view.step
        if self.every and view.step // self.every > last // self.every:
            self._publish(view)

    def on_fit_end(self, view: Optional[SweepView]) -> None:
        if self.include_last and view is not None:
            self._publish(view)


class TraceCallback(Callback):
    """Attach the ``repro_torch.obs`` telemetry plane to one fit.

    Two modes:

      * ``TraceCallback(ObsConfig(enabled=True, out_dir=...))`` -- the
        callback *owns* an obs session: installed at ``on_fit_start``,
        saved (trace.json + metrics.jsonl under ``out_dir``) and closed
        at ``on_fit_end``.  This is the hook for runs driven through
        hand-built planes, where no ``LDAJob.obs`` exists to do the
        wiring.
      * ``TraceCallback()`` -- adopt whatever session is already
        installed (e.g. by ``Session.run`` honouring ``LDAJob.obs``) and
        only contribute the per-visit spans.

    Either way the callback is an observer like every other: it reads
    clocks and the view, and never touches the state or the random
    stream, so the trained model is bitwise identical with or without it.
    Per visit it records a ``session.visit`` span (host wall time from
    the previous visit boundary) and a ``tokens_seen`` counter series;
    ``fit.start`` and ``fit.end`` are instant events.
    """

    def __init__(self, obs_cfg: Optional["_obs.ObsConfig"] = None):
        self.obs_cfg = obs_cfg
        self._session: Optional["_obs.ObsSession"] = None
        self._last_ns: Optional[int] = None

    def on_fit_start(self, info: dict) -> None:
        if (self.obs_cfg is not None and self.obs_cfg.enabled
                and _obs.active() is None):
            self._session = _obs.ObsSession(self.obs_cfg).install()
        tr = _obs.tracer()
        if tr is not None:
            tr.instant("fit.start", cat="session",
                       **{k: v for k, v in info.items()
                          if isinstance(v, (int, float, str, bool,
                                            type(None)))})
        self._last_ns = time.perf_counter_ns()

    def on_sweep_end(self, view: SweepView) -> None:
        tr = _obs.tracer()
        if tr is None:
            return
        now = time.perf_counter_ns()
        if self._last_ns is not None:
            tr.complete("session.visit", self._last_ns, now, cat="session",
                        step=view.step, epoch=view.epoch,
                        shard=view.shard_id)
        tr.counter("tokens_seen", tokens=view.tokens_seen)
        self._last_ns = now

    def on_fit_end(self, view: Optional[SweepView]) -> None:
        tr = _obs.tracer()
        if tr is not None:
            tr.instant("fit.end", cat="session")
        if self._session is not None:
            self._session.close(save=True)
            self._session = None
