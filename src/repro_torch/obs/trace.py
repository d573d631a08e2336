"""Host-side span tracing with Chrome-trace/Perfetto JSON output.

A ``Span`` is a host-timed interval (``time.perf_counter_ns``) recorded as
a Chrome ``"ph": "X"`` complete event.  The tracer is process-wide and
thread-safe: each thread's spans land on its own track (``tid``), so the
serving threads' overlap is visible in the Perfetto timeline, and
synthetic *lanes* (tids >= ``LANE_BASE``) hold timelines that are not
threads, such as the device's share of a training sweep.

Two invariants, enforced here rather than at every call site:

  * **zero perturbation** -- the tracer only ever *reads* clocks and
    (optionally) synchronises the device of a CUDA tensor the caller was
    about to wait on anyway.  Nothing recorded feeds back into the traced
    computation, so results with tracing on are bitwise identical to
    tracing off.
  * **no-op under compilation** -- a span opened while ``torch.compile``
    traces a function would record compile time, not run time;
    ``_host_time_ok`` checks ``torch.compiler.is_compiling()`` and the span
    degrades to ``NULL_SPAN``.

This module is dependency-free (stdlib only): torch is looked up lazily in
``sys.modules``, so numpy-only importers stay torch-free.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

LANE_BASE = 1_000_000   # first tid of the synthetic lanes, past any thread


def _host_time_ok() -> bool:
    """True when it is safe to record host wall time (i.e. we are NOT
    inside a ``torch.compile`` trace).  torch is looked up lazily via
    ``sys.modules`` so importing this module never imports it."""
    torch = sys.modules.get("torch")
    if torch is None:
        return True
    return not torch.compiler.is_compiling()


def _block(value: Any) -> None:
    """Wait for the device of ``value`` when it is a CUDA tensor; a no-op
    for anything else (CPU tensors are computed eagerly)."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(value, torch.Tensor):
        return
    if value.is_cuda:
        torch.cuda.synchronize(value.device)


class Span:
    """One open interval; close with ``__exit__`` or ``end()``.

    ``sync=value`` (or ``span.sync_on(value)``) makes the close a device
    boundary: the device of ``value`` is synchronised first, so the
    recorded duration covers the device work the caller is timing.
    """

    __slots__ = ("tracer", "name", "cat", "args", "_t0", "_sync")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]], sync: Any = None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._sync = sync
        self._t0 = time.perf_counter_ns()

    def sync_on(self, value: Any) -> Any:
        """Register ``value`` to be synchronised at span close; returns it
        unchanged so call sites can wrap an expression."""
        self._sync = value
        return value

    def set(self, **kw) -> None:
        """Attach extra args to the span (merged at close)."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)

    def end(self) -> float:
        """Close the span; returns duration in milliseconds."""
        if self._sync is not None and self.tracer.sync_spans:
            _block(self._sync)
            self._sync = None
        t1 = time.perf_counter_ns()
        self.tracer._complete(self.name, self.cat, self._t0, t1,
                              self.args)
        return (t1 - self._t0) / 1e6

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """The do-nothing span: returned when tracing is off or compiling.
    A single shared instance; every method is a cheap no-op."""

    __slots__ = ()

    def sync_on(self, value: Any) -> Any:
        return value

    def set(self, **kw) -> None:
        pass

    def end(self) -> float:
        return 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Process-wide Chrome-trace event collector.

    Events accumulate in memory (a traced run is minutes, not days; the
    event dicts are small) and are written once by ``save``.  All methods
    are thread-safe; the hot path (``span`` with tracing off) never takes
    the lock.
    """

    def __init__(self, sync_spans: bool = True, pid: int = 0):
        self.sync_spans = sync_spans
        self.pid = pid if pid else os.getpid()
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}      # thread ident -> small tid
        self._lanes: Dict[str, int] = {}     # lane name -> synthetic tid
        self._epoch_ns = time.perf_counter_ns()

    # -- track bookkeeping ------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids)
                self._tids[ident] = tid
                name = threading.current_thread().name
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid, "args": {"name": name}})
        return tid

    def lane(self, name: str) -> int:
        """A synthetic track for a timeline that is not a host thread (the
        device's share of a sweep).  Stable per name."""
        with self._lock:
            tid = self._lanes.get(name)
            if tid is None:
                tid = LANE_BASE + len(self._lanes)
                self._lanes[name] = tid
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self.pid,
                    "tid": tid, "args": {"name": f"[{name}]"}})
        return tid

    def _us(self, t_ns: int) -> float:
        return (t_ns - self._epoch_ns) / 1e3

    # -- event emission ---------------------------------------------------
    def _complete(self, name: str, cat: str, t0_ns: int, t1_ns: int,
                  args: Optional[dict], tid: Optional[int] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "pid": self.pid,
              "tid": self._tid() if tid is None else tid,
              "ts": self._us(t0_ns), "dur": (t1_ns - t0_ns) / 1e3}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, cat: str = "host", sync: Any = None,
             **args) -> Span:
        """Open a span.  Under ``torch.compile`` this returns ``NULL_SPAN``."""
        if not _host_time_ok():
            return NULL_SPAN
        return Span(self, name, cat, args or None,
                    sync=sync if self.sync_spans else None)

    def complete(self, name: str, t0_ns: int, t1_ns: int, cat: str = "host",
                 tid: Optional[int] = None, **args) -> None:
        """Record an interval measured elsewhere (``perf_counter_ns``
        endpoints), on the calling thread's track or on lane ``tid``."""
        self._complete(name, cat, t0_ns, t1_ns, args or None, tid)

    # -- output -----------------------------------------------------------
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            doc = {"traceEvents": list(self._events),
                   "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
