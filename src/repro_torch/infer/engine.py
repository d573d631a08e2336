"""Batched topic-inference query engine.

Serving requests arrive one document at a time; the card wants dense
batches.  The engine bridges the two with *padding-bucket batching*: each
request's token count is rounded up to a power-of-two bucket, requests in
the same bucket are packed into fixed-size [max_batch, bucket] batches
(short batches padded with dummy rows), and one ``fold_in_batch`` call
serves the whole batch.  Shapes stay within (#buckets) kinds, and --
because fold-in randomness is per-document (see infer/foldin.py) -- a
request's θ is bit-identical no matter which batch it lands in or in which
order requests arrived.

Two serving disciplines share that batching core:

  * ``QueryEngine``      -- synchronous: callers ``submit()`` then
    ``flush()`` on one thread (offline/batch scoring, tests);
  * ``ConcurrentEngine`` -- the production plane: a thread-safe
    admission queue whose ``submit()`` returns a waitable
    ``Ticket``, drained by a background batcher under a dual trigger
    (bucket full OR oldest request aged past ``max_delay_ms``), with
    per-request SLO deadlines enforced by typed load-shedding
    (``DeadlineExceeded``) instead of silent queue growth.

Scoring implements the paper's IR smoothing use case: topic-smoothed query
likelihood (the LDA-based document model of Wei & Croft 2006),

  p(w|d) = λ · Σ_k θ_dk φ_wk  +  (1-λ) · (c(w,d) + μ p(w|C)) / (|d| + μ)

i.e. the LDA term interpolated with a Dirichlet-smoothed document language
model; documents are ranked by Σ_{w∈q} log p(w|d).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from functools import partial
from typing import (Deque, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import rng as jrng
from repro_torch.infer.foldin import FoldInConfig, fold_in_batch, pack_docs
from repro_torch.infer.snapshot import Snapshot, SnapshotPublisher


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 32          # rows per fold-in call
    min_bucket: int = 16         # smallest padding bucket (tokens)
    max_len: int = 1024          # longest supported doc (longer: truncated)
    foldin: FoldInConfig = FoldInConfig()
    smooth_lambda: float = 0.7   # weight of the LDA term in p(w|d)
    smooth_mu: float = 100.0     # Dirichlet prior mass of the doc LM
    # concurrent admission (ConcurrentEngine)
    max_delay_ms: float = 5.0    # oldest queued request before a forced flush
    deadline_ms: float = 0.0     # default per-request SLO (0: no deadline)


def _admit_tokens(tokens: Sequence[int], max_len: int) -> np.ndarray:
    """Admission-time canonical form of a request's tokens: int32, truncated
    to ``max_len`` (the longest supported doc)."""
    tok = np.asarray(tokens, np.int32)
    return tok[:max_len] if tok.shape[0] > max_len else tok


class Request(NamedTuple):
    rid: int
    tokens: np.ndarray
    seed: int


class Result(NamedTuple):
    rid: int
    theta: np.ndarray    # [K]
    version: int         # snapshot version that served this request


class QueryEngine:
    """Request queue + bucket batcher over a snapshot source.

    ``source`` is either a ``SnapshotPublisher`` (live serving: every flush
    re-acquires the latest published version) or a single ``Snapshot``
    (offline/batch scoring).
    """

    def __init__(self, source: Union[SnapshotPublisher, Snapshot],
                 ecfg: EngineConfig = EngineConfig()):
        self._source = source
        self.ecfg = ecfg
        self._queue: List[Request] = []
        self._next_rid = 0
        # snapshots recently used to serve requests, by version -- retained
        # so scoring can use the same model version that produced a θ even
        # if training has published a newer one in between
        self._recent: Dict[int, Snapshot] = {}
        # request-id -> submit time (perf_counter_ns), the start of the
        # per-request latency window the obs plane reports p50/p95/p99
        # over; entries are dropped as requests are served
        self._t_submit: Dict[int, int] = {}

    # -- snapshot plumbing ----------------------------------------------
    def snapshot(self) -> Snapshot:
        if isinstance(self._source, SnapshotPublisher):
            snap = self._source.acquire()
            if snap is None:
                raise RuntimeError("no snapshot published yet")
            return snap
        return self._source

    def _retain(self, snap: Snapshot) -> Snapshot:
        self._recent[snap.version] = snap
        while len(self._recent) > 2:          # mirror the double buffer
            self._recent.pop(min(self._recent))
        return snap

    # -- queueing --------------------------------------------------------
    def bucket_of(self, n: int) -> int:
        """Smallest power-of-two bucket >= n, clamped to ``max_len`` (docs
        longer than ``max_len`` are truncated to it)."""
        b = self.ecfg.min_bucket
        while b < n and b < self.ecfg.max_len:
            b *= 2
        return min(b, self.ecfg.max_len)

    def submit(self, tokens: Sequence[int],
               seed: Optional[int] = None) -> int:
        """Enqueue one document; returns the request id.

        ``seed`` pins the request's fold-in randomness: same (snapshot,
        tokens, seed) -> bit-identical θ regardless of batching.  Defaults
        to the request id (unique, but arrival-order dependent).

        Documents longer than ``max_len`` are truncated *here*, at
        admission: the queue never holds more than ``max_len`` tokens per
        request, and ``_run_batch`` always receives docs that fit their
        bucket (``bucket_of`` promises exactly this).
        """
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(
            rid, _admit_tokens(tokens, self.ecfg.max_len),
            rid if seed is None else seed))
        reg = _obs.metrics_for(self.ecfg.foldin.obs)
        if reg is not None:
            self._t_submit[rid] = time.perf_counter_ns()
            reg.gauge("serve.queue_depth").set(len(self._queue))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- serving ---------------------------------------------------------
    def flush(self) -> Dict[int, Result]:
        """Serve every queued request; returns {rid: Result}.

        Requests are grouped into padding buckets and each bucket drained
        in fixed [max_batch, bucket] batches (dummy rows pad the last one).
        """
        snap = self._retain(self.snapshot())
        queue, self._queue = self._queue, []
        buckets: Dict[int, List[Request]] = {}
        for req in queue:
            buckets.setdefault(
                self.bucket_of(max(len(req.tokens), 1)), []).append(req)

        reg = _obs.metrics_for(self.ecfg.foldin.obs)
        tr = _obs.tracer_for(self.ecfg.foldin.obs)
        flush_sp = (tr.span("engine.flush", cat="serve",
                            requests=len(queue), version=snap.version)
                    if tr is not None else _obs.NULL_SPAN)
        out: Dict[int, Result] = {}
        mb = self.ecfg.max_batch
        for bucket in sorted(buckets):
            reqs = buckets[bucket]
            for i in range(0, len(reqs), mb):
                chunk = reqs[i:i + mb]
                batch_sp = (tr.span("engine.batch", cat="serve",
                                    bucket=bucket, occupancy=len(chunk),
                                    max_batch=mb)
                            if tr is not None else _obs.NULL_SPAN)
                # _run_batch ends on a copy to the host: the batch is
                # synced by the time the span closes
                with batch_sp:
                    theta = self._run_batch(snap, chunk, bucket)
                t_done = time.perf_counter_ns()
                for j, req in enumerate(chunk):
                    out[req.rid] = Result(req.rid, theta[j], snap.version)
                if reg is not None:
                    reg.histogram("serve.batch_occupancy", unit="reqs") \
                        .record(len(chunk))
                for req in chunk:
                    # ALWAYS pop: a request served while metrics are off
                    # (or toggled between submit and flush) must not pin
                    # its submit timestamp forever in a long-lived server
                    t0 = self._t_submit.pop(req.rid, None)
                    if t0 is not None and reg is not None:
                        reg.histogram("serve.request_ms").record(
                            (t_done - t0) / 1e6)
        if reg is not None:
            reg.gauge("serve.queue_depth").set(len(self._queue))
            reg.gauge("serve.snapshot_version").set(snap.version)
        flush_sp.end()
        return out

    def _run_batch(self, snap: Snapshot, chunk: List[Request],
                   bucket: int) -> np.ndarray:
        """One fold-in call at the fixed [max_batch, bucket] shape, on the
        snapshot's device (pad rows use seed 0)."""
        mb = self.ecfg.max_batch
        docs = [r.tokens for r in chunk]
        w, valid = pack_docs(docs, bucket)
        pad = mb - len(chunk)
        if pad:
            w = np.pad(w, ((0, pad), (0, 0)))
            valid = np.pad(valid, ((0, pad), (0, 0)))
        dev = snap.device
        keys = jrng.keys_from_seeds([r.seed for r in chunk] + [0] * pad, dev)
        theta = fold_in_batch(snap.model, torch.from_numpy(w).to(dev),
                              torch.from_numpy(valid).to(dev), keys,
                              snap.cfg, self.ecfg.foldin)
        return theta[:len(chunk)].cpu().numpy()

    def infer(self, docs: Sequence[np.ndarray],
              seeds: Optional[Sequence[int]] = None) -> List[Result]:
        """Submit + flush convenience; results in input order."""
        rids = [self.submit(doc, None if seeds is None else seeds[i])
                for i, doc in enumerate(docs)]
        results = self.flush()
        return [results[rid] for rid in rids]

    # -- IR scoring (the paper's smoothing use case) ---------------------
    def score(self, results: Sequence[Result],
              docs: Sequence[np.ndarray],
              queries: Sequence[np.ndarray]) -> np.ndarray:
        """Topic-smoothed query-likelihood scores [num_queries, num_docs].

        Scoring uses the SAME snapshot version that produced the θs
        (carried in ``Result.version``): mixing a v1 θ with a v2 φ would
        score against an inconsistent model.  Recently served versions are
        retained by the engine; scoring θs older than that raises.

        Pack lengths are rounded up to the engine's power-of-two buckets
        (``bucket_of``), so scoring sees at most #buckets² shapes, as
        fold-in does.
        """
        versions = {r.version for r in results}
        if len(versions) != 1:
            raise ValueError(f"results span snapshot versions {sorted(versions)}; "
                             "score each version separately")
        version = versions.pop()
        snap = self._recent.get(version)
        if snap is None:
            snap = self.snapshot()
            if snap.version != version:
                raise ValueError(
                    f"snapshot v{version} no longer available (current "
                    f"v{snap.version}); re-run fold-in before scoring")
        ld = self.bucket_of(max(max((len(d) for d in docs), default=1), 1))
        lq = self.bucket_of(max(max((len(q) for q in queries), default=1), 1))
        dw, dv = pack_docs(docs, ld)
        qw, qv = pack_docs(queries, lq)
        dev = snap.device
        theta = torch.from_numpy(np.stack([r.theta for r in results])).to(dev)
        return topic_smoothed_scores(
            theta, torch.from_numpy(dw).to(dev), torch.from_numpy(dv).to(dev),
            torch.from_numpy(qw).to(dev), torch.from_numpy(qv).to(dev),
            snap.phi, snap.p_coll, self.ecfg.smooth_lambda,
            self.ecfg.smooth_mu).cpu().numpy()


def topic_smoothed_scores(theta: torch.Tensor, doc_w: torch.Tensor,
                          doc_valid: torch.Tensor, q_w: torch.Tensor,
                          q_valid: torch.Tensor, phi: torch.Tensor,
                          p_coll: torch.Tensor, lam: float,
                          mu: float) -> torch.Tensor:
    """log p(q|d) under the λ-interpolated LDA document model.

    theta [B, K]; doc_w/doc_valid [B, Ld]; q_w/q_valid [Q, Lq];
    phi [V, K]; p_coll [V].  Returns [Q, B].
    """
    doc_len = doc_valid.sum(1).to(torch.float32)                     # [B]
    q_idx = q_w.long()

    # p_lda(t|d) = Σ_k θ_dk φ_tk for every query term t: [Q, Lq, B]
    phi_q = phi[q_idx]                                               # [Q,Lq,K]
    p_lda = torch.einsum("qlk,bk->qlb", phi_q, theta)

    # c(t, d): occurrences of each query term in each doc's tokens
    match = q_w[:, :, None, None] == doc_w[None, None, :, :]         # [Q,Lq,B,Ld]
    c = (match & doc_valid[None, None, :, :]).sum(-1).to(torch.float32)
    p_c = p_coll[q_idx][:, :, None]                                  # [Q,Lq,1]
    p_dir = (c + mu * p_c) / (doc_len[None, None, :] + mu)

    p = lam * p_lda + (1.0 - lam) * p_dir
    logp = torch.log(torch.clamp_min(p, 1e-30))
    return torch.where(q_valid[:, :, None], logp,
                       torch.zeros_like(logp)).sum(1)


# ---------------------------------------------------------------------------
# Concurrent serving plane.
# ---------------------------------------------------------------------------

class DeadlineExceeded(RuntimeError):
    """Typed load-shed: the request aged past its SLO deadline while
    queued, so the batcher refused it instead of serving it late.

    Raised out of ``Ticket.result()`` on the submitter's thread; carries
    the request id, how long it sat queued, and the deadline it missed.
    Shedding is the back-pressure mechanism: under overload the queue
    stays bounded and late requests fail *loudly and typed* rather than
    silently stretching every other request's latency.
    """

    def __init__(self, rid: int, waited_ms: float, deadline_ms: float):
        super().__init__(
            f"request {rid} shed after {waited_ms:.2f} ms queued "
            f"(deadline {deadline_ms:.2f} ms)")
        self.rid = rid
        self.waited_ms = waited_ms
        self.deadline_ms = deadline_ms


class Ticket:
    """Waitable handle for one admitted request.

    The submitter blocks on ``result()`` until the batcher either serves
    the request (returns its ``Result``) or sheds it (raises
    ``DeadlineExceeded``); any internal batch failure is re-raised as-is.
    A ticket completes exactly once, always from the batcher thread.
    """

    __slots__ = ("rid", "_done", "_result", "_error")

    def __init__(self, rid: int):
        self.rid = rid
        self._done = threading.Event()
        self._result: Optional[Result] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Result:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served within "
                               f"{timeout}s (still queued or in flight)")
        if self._error is not None:
            raise self._error
        return self._result

    # -- batcher side (exactly-once completion) --------------------------
    def _complete(self, result: Result) -> None:
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()


class _Admitted(NamedTuple):
    """One queued request: ticket + request + its admission bookkeeping."""
    ticket: Ticket
    request: Request
    bucket: int
    t_submit_ns: int
    t_deadline_ns: Optional[int]   # absolute shed time (None: no deadline)


class ConcurrentEngine:
    """Thread-safe admission queue + latency-bounded background batcher.

    Production model servers get throughput from *dynamic batching over
    concurrent clients*: many independent submitters, one batcher thread
    assembling dense [max_batch, bucket] fold-in calls.  The assembly
    discipline is the classic dual trigger:

      * **full**    -- a padding bucket reaches ``max_batch`` queued
        requests: flush immediately (throughput trigger);
      * **timeout** -- the oldest queued request has waited
        ``max_delay_ms``: flush its bucket even part-full (latency
        trigger -- no request waits unboundedly for co-batchees);
      * **drain**   -- ``close(drain=True)``: flush the remainder.

    Requests whose SLO deadline passes before their batch is assembled
    are *shed*: their ticket raises ``DeadlineExceeded`` and the
    ``serve.shed`` counter increments -- typed back-pressure instead of
    silent queue growth.  Once a request makes it into a batch it is
    always served, even if the device work completes past its deadline
    (the deadline bounds *queueing*, the batcher never wastes done work).

    θ determinism is inherited from the fold-in contract: per-request θ
    is a pure function of (snapshot, tokens, seed), so however the
    dynamic batches slice the arrival stream, a pinned request is
    bit-identical to its synchronous ``QueryEngine`` serving.  Each batch
    re-acquires the latest published snapshot, which is what makes
    zero-downtime live refresh free: a publisher flip between two batches
    simply routes the next batch to the new version.
    """

    def __init__(self, engine: QueryEngine,
                 max_delay_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None):
        self.engine = engine
        ecfg = engine.ecfg
        self.max_delay_ms = (ecfg.max_delay_ms if max_delay_ms is None
                             else float(max_delay_ms))
        self.deadline_ms = (ecfg.deadline_ms if deadline_ms is None
                            else float(deadline_ms))
        self._cond = threading.Condition()
        self._buckets: Dict[int, Deque[_Admitted]] = {}
        self._pending = 0
        self._next_rid = 0
        self._stop = False
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        # lifetime outcome counters (mirrored into the obs registry when
        # one is installed; kept here so callers can assert without obs)
        self.served = 0
        self.shed = 0
        self.failed = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ConcurrentEngine":
        with self._cond:
            if self._thread is not None:
                raise RuntimeError("batcher already running")
            self._stop = False
            self._thread = threading.Thread(
                target=self._serve_loop, name="repro-serve-batcher",
                daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the batcher.  ``drain=True`` serves everything still
        queued first; ``drain=False`` fails the remainder (each pending
        ticket raises RuntimeError)."""
        with self._cond:
            if self._thread is None:
                return
            self._stop = True
            self._drain = drain
            self._cond.notify_all()
            thread = self._thread
        thread.join()
        with self._cond:
            self._thread = None

    def __enter__(self) -> "ConcurrentEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def pending(self) -> int:
        with self._cond:
            return self._pending

    # -- admission (any thread) ------------------------------------------
    def submit(self, tokens: Sequence[int], seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> Ticket:
        """Admit one document; returns a waitable ``Ticket``.

        ``seed`` pins fold-in randomness exactly as in
        ``QueryEngine.submit``; ``deadline_ms`` overrides the engine-wide
        SLO for this request (0 disables).  Tokens beyond ``max_len`` are
        truncated at admission.
        """
        tok = _admit_tokens(tokens, self.engine.ecfg.max_len)
        dl = self.deadline_ms if deadline_ms is None else float(deadline_ms)
        now = time.perf_counter_ns()
        with self._cond:
            if self._thread is None or self._stop:
                raise RuntimeError("serving is not running (start() first)")
            rid = self._next_rid
            self._next_rid += 1
            ticket = Ticket(rid)
            entry = _Admitted(
                ticket, Request(rid, tok, rid if seed is None else seed),
                self.engine.bucket_of(max(tok.shape[0], 1)), now,
                now + int(dl * 1e6) if dl > 0 else None)
            self._buckets.setdefault(entry.bucket,
                                     collections.deque()).append(entry)
            self._pending += 1
            depth = self._pending
            self._cond.notify()
        reg = _obs.metrics_for(self.engine.ecfg.foldin.obs)
        if reg is not None:
            reg.gauge("serve.queue_depth").set(depth)
        return ticket

    # -- batcher thread ---------------------------------------------------
    def _serve_loop(self) -> None:
        while True:
            with self._cond:
                now = time.perf_counter_ns()
                expired = self._pop_expired(now)
                batch, trigger = self._assemble(now)
                done = self._stop and batch is None and self._pending == 0
                if batch is None and not expired and not done:
                    self._cond.wait(timeout=self._wait_s(now))
            for entry in expired:
                self._shed_one(entry)
            if batch is not None:
                self._serve(batch, trigger)
            elif done and not expired:
                return

    def _pop_expired(self, now_ns: int) -> List[_Admitted]:
        """Remove every queued request whose deadline has passed (called
        under the lock; tickets are failed outside it)."""
        out: List[_Admitted] = []
        for bucket, dq in self._buckets.items():
            if any(e.t_deadline_ns is not None and e.t_deadline_ns <= now_ns
                   for e in dq):
                keep = collections.deque()
                for e in dq:
                    if (e.t_deadline_ns is not None
                            and e.t_deadline_ns <= now_ns):
                        out.append(e)
                    else:
                        keep.append(e)
                self._buckets[bucket] = keep
        self._pending -= len(out)
        return out

    def _assemble(self, now_ns: int) -> Tuple[Optional[List[_Admitted]],
                                              Optional[str]]:
        """Dual-trigger batch assembly (called under the lock).

        Priority: any full bucket first (throughput), else the bucket
        whose head has aged past ``max_delay_ms`` (latency), else -- when
        stopping with ``drain`` -- the oldest bucket outright.
        """
        mb = self.engine.ecfg.max_batch
        aged_ns = int(self.max_delay_ms * 1e6)
        oldest_bucket, oldest_t = None, None
        for bucket in sorted(self._buckets):
            dq = self._buckets[bucket]
            if not dq:
                continue
            if len(dq) >= mb:
                return self._take(bucket, mb), "full"
            if oldest_t is None or dq[0].t_submit_ns < oldest_t:
                oldest_bucket, oldest_t = bucket, dq[0].t_submit_ns
        if oldest_bucket is None:
            return None, None
        if now_ns - oldest_t >= aged_ns:
            return self._take(oldest_bucket, mb), "timeout"
        if self._stop:
            if not self._drain:
                for bucket in list(self._buckets):
                    for e in self._take(bucket, self._pending + mb):
                        e.ticket._fail(RuntimeError(
                            f"request {e.request.rid} dropped: serving "
                            f"stopped without drain"))
                        self.failed += 1
                return None, None
            return self._take(oldest_bucket, mb), "drain"
        return None, None

    def _take(self, bucket: int, n: int) -> List[_Admitted]:
        dq = self._buckets[bucket]
        out = [dq.popleft() for _ in range(min(n, len(dq)))]
        self._pending -= len(out)
        return out

    def _wait_s(self, now_ns: int) -> Optional[float]:
        """Sleep until the next time-based trigger could fire: the oldest
        head ageing out, or the earliest queued deadline (None: idle)."""
        next_ns = None
        aged_ns = int(self.max_delay_ms * 1e6)
        for dq in self._buckets.values():
            for e in dq:
                cands = [e.t_submit_ns + aged_ns]
                if e.t_deadline_ns is not None:
                    cands.append(e.t_deadline_ns)
                t = min(cands)
                if next_ns is None or t < next_ns:
                    next_ns = t
        if next_ns is None:
            return None
        return max((next_ns - now_ns) / 1e9, 0.0)

    def _shed_one(self, entry: _Admitted) -> None:
        now = time.perf_counter_ns()
        waited_ms = (now - entry.t_submit_ns) / 1e6
        deadline_ms = (entry.t_deadline_ns - entry.t_submit_ns) / 1e6
        entry.ticket._fail(DeadlineExceeded(entry.request.rid, waited_ms,
                                            deadline_ms))
        self.shed += 1
        reg = _obs.metrics_for(self.engine.ecfg.foldin.obs)
        if reg is not None:
            reg.counter("serve.shed").inc()

    def _serve(self, batch: List[_Admitted], trigger: str) -> None:
        engine = self.engine
        reqs = [e.request for e in batch]
        bucket = batch[0].bucket
        reg = _obs.metrics_for(engine.ecfg.foldin.obs)
        tr = _obs.tracer_for(engine.ecfg.foldin.obs)
        try:
            snap = engine._retain(engine.snapshot())
            sp = (tr.span("engine.batch", cat="serve", bucket=bucket,
                          occupancy=len(batch), trigger=trigger,
                          max_batch=engine.ecfg.max_batch)
                  if tr is not None else _obs.NULL_SPAN)
            with sp:
                theta = engine._run_batch(snap, reqs, bucket)
        except BaseException as exc:   # noqa: BLE001 -- fail the tickets,
            for e in batch:            # never wedge their submitters
                e.ticket._fail(exc)
            self.failed += len(batch)
            if reg is not None:
                reg.counter("serve.batch_errors").inc(len(batch))
            return
        t_done = time.perf_counter_ns()
        for j, e in enumerate(batch):
            e.ticket._complete(Result(e.request.rid, theta[j], snap.version))
        self.served += len(batch)
        if reg is not None:
            reg.counter(f"serve.batch_trigger.{trigger}").inc()
            reg.histogram("serve.batch_occupancy", unit="reqs") \
                .record(len(batch))
            for e in batch:
                reg.histogram("serve.request_ms").record(
                    (t_done - e.t_submit_ns) / 1e6)
            reg.gauge("serve.snapshot_version").set(snap.version)
            src = engine._source
            if isinstance(src, SnapshotPublisher):
                # bounded staleness, made measurable: how many published
                # versions the batch just served lags the newest
                reg.gauge("serve.version_lag").set(src.version
                                                   - snap.version)
