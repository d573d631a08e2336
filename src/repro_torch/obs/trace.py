"""Host-side span tracing with Chrome-trace/Perfetto JSON output.

A ``Span`` is a host-timed interval (``time.perf_counter_ns``) recorded as
a Chrome ``"ph": "X"`` complete event.  The tracer is process-wide and
thread-safe: each thread's spans land on its own track (``tid``), so the
serving threads' overlap is visible in the Perfetto timeline, and
synthetic *lanes* (tids >= ``LANE_BASE``) hold timelines that are not
threads, such as the device's share of a training sweep.

While a ``torch.profiler`` records, each live span is also a
``record_function`` range of its name, so the profiler's trace shows the
program's spans (as ``user_annotation``s) on one clock with the device's
operations.  A ``DeviceTimeline`` times phases on the device itself: CUDA
events at each boundary, read once a wait the caller makes anyway has
covered them, and put on the ``[device]`` lane by ``Tracer.flush_device``.

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


def _profiler_range(name: str) -> Any:
    """A ``torch.profiler.record_function`` range called ``name``, entered,
    while a profiler records; None (and nothing entered) otherwise."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(name)
    rf.__enter__()
    return rf


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
    recorded duration covers the device work the caller is timing.  While
    a profiler records, the span is also a ``record_function`` range.
    """

    __slots__ = ("tracer", "name", "cat", "args", "_t0", "_sync", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]], sync: Any = None):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._sync = sync
        self._t0 = time.perf_counter_ns()
        self._range = _profiler_range(name)

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
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
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


class _DeviceMarks:
    """Marks on a device: CUDA events on the card's current stream, which
    nothing here waits for, or the host clock on the CPU (which runs each
    operation as it is issued).  ``cat`` names the device type; ``waited``
    is ``(anchor, t_wait_ns)`` once a wait has covered the marks."""

    __slots__ = ("cat", "ended", "waited", "_stream", "_marks")

    def __init__(self, device: Any):
        self.cat = device.type
        self.ended = False
        self.waited: Optional[tuple] = None
        self._stream = (sys.modules["torch"].cuda.current_stream(device)
                        if self.cat == "cuda" else None)
        self._marks: List[Any] = []

    def _mark(self) -> int:
        if self._stream is None:
            self._marks.append(time.perf_counter_ns())
        else:
            ev = sys.modules["torch"].cuda.Event(enable_timing=True)
            ev.record(self._stream)
            self._marks.append(ev)
        return len(self._marks) - 1

    def last_event(self) -> Any:
        """The last CUDA event, or None on the CPU."""
        return self._marks[-1] if self._stream is not None else None

    def _times(self, anchor: Any, t_wait_ns: int) -> List[int]:
        """Each mark on the host clock: a CUDA event's is ``t_wait_ns``
        less the device time from it to ``anchor``, the last event that
        the wait covered."""
        if self._stream is None:
            return self._marks
        return [t_wait_ns - round(ev.elapsed_time(anchor) * 1e6)
                for ev in self._marks]


class DeviceTimeline(_DeviceMarks):
    """One sweep's phases as the device ran them.

    ``mark(name, group, args)`` starts phase ``name`` of ``group`` (-1:
    outside any group) where the phase before it ends, and ``end()`` ends
    the last.  On a CUDA device a mark records a timing event on the
    device's current stream and nothing waits for it; the events are read
    only once a wait the caller makes anyway has covered them
    (``Tracer.device_waited``, then ``Tracer.flush_device``).  On the CPU,
    which runs each operation as it is issued, a mark is the host clock.
    """

    __slots__ = ("_phases",)

    def __init__(self, device: Any):
        super().__init__(device)
        self._phases: List[tuple] = []

    def mark(self, name: str, group: int = -1,
             args: Optional[dict] = None) -> None:
        self._phases.append((name, group, args))
        self._mark()

    def end(self) -> None:
        self._mark()
        self.ended = True

    def spans(self, anchor: Any, t_wait_ns: int) -> List[tuple]:
        """``(name, t0_ns, t1_ns, args)`` of the whole sweep
        (``sweep.device``), each group (``exec.group``, its first mark's
        args) and each phase, on the host clock (``_times``)."""
        ts = self._times(anchor, t_wait_ns)
        out = [("sweep.device", ts[0], ts[-1], None)]
        for i, (name, grp, args) in enumerate(self._phases):
            if grp < 0:
                out.append((name, ts[i], ts[i + 1], None))
                continue
            if i == 0 or self._phases[i - 1][1] != grp:
                first = i
            out.append((name, ts[i], ts[i + 1], {"group": grp}))
            if i + 1 == len(self._phases) or self._phases[i + 1][1] != grp:
                out.append(("exec.group", ts[first], ts[i + 1],
                            dict(self._phases[first][2] or {}, group=grp)))
        return out


class DeviceSpans(_DeviceMarks):
    """One step's spans as the device ran them, each between two marks
    that need not be neighbours: the step itself (``name``) and any
    ``open``/``close`` pair inside it, nested or apart, closed in any
    order.  The marks are read as a ``DeviceTimeline``'s, and a span left
    open is dropped."""

    __slots__ = ("_spans",)

    def __init__(self, device: Any, name: str):
        super().__init__(device)
        self._spans: List[list] = []
        self.open(name)

    def open(self, name: str, **args) -> list:
        """Start span ``name`` here; ``close`` ends it."""
        span = [name, self._mark(), None, args or None]
        self._spans.append(span)
        return span

    def close(self, span: list) -> None:
        span[2] = self._mark()

    def end(self) -> None:
        """End the step (its first span)."""
        self.close(self._spans[0])
        self.ended = True

    def spans(self, anchor: Any, t_wait_ns: int) -> List[tuple]:
        """``(name, t0_ns, t1_ns, args)`` of each closed span on the host
        clock."""
        ts = self._times(anchor, t_wait_ns)
        return [(name, ts[i0], ts[i1], args)
                for name, i0, i1, args in self._spans if i1 is not None]


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
        self._pending: List[DeviceTimeline] = []
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

    def device_timeline(self, device: Any) -> DeviceTimeline:
        """A timeline of phases on ``device`` (a ``torch.device``), put on
        the ``[device]`` lane by the first ``flush_device`` after a wait
        that covers it (``device_waited``)."""
        tl = DeviceTimeline(device)
        with self._lock:
            self._pending.append(tl)
        return tl

    def device_spans(self, device: Any, name: str) -> DeviceSpans:
        """A step's spans on ``device``, put on the ``[device]`` lane as a
        ``device_timeline``'s are."""
        ds = DeviceSpans(device, name)
        with self._lock:
            self._pending.append(ds)
        return ds

    def device_waited(self, t_wait_ns: int) -> None:
        """A wait on the device returned at ``t_wait_ns`` (host clock): it
        covers every timeline that has ended, whose events are therefore
        done.  Each is anchored at the last of them; nothing is read yet."""
        with self._lock:
            ended = [tl for tl in self._pending
                     if tl.ended and tl.waited is None]
            anchor = next((tl.last_event() for tl in reversed(ended)
                           if tl.last_event() is not None), None)
            for tl in ended:
                tl.waited = (anchor, t_wait_ns)

    def flush_device(self, wait: bool = False) -> None:
        """Put the timelines that a wait has covered on the ``[device]``
        lane (their ``cat`` the device type).  ``wait``: first wait for the
        last event of those that ended uncovered (a session's close)."""
        if wait:
            with self._lock:
                last = next((tl.last_event() for tl in reversed(self._pending)
                             if tl.ended and tl.waited is None
                             and tl.last_event() is not None), None)
            if last is not None:
                last.synchronize()
            self.device_waited(time.perf_counter_ns())
        with self._lock:
            done = [tl for tl in self._pending if tl.waited is not None]
            self._pending = [tl for tl in self._pending if tl.waited is None]
        if not done:
            return
        tid = self.lane("device")
        for tl in done:
            for name, t0, t1, args in tl.spans(*tl.waited):
                self._complete(name, tl.cat, t0, t1, args, tid)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """A Chrome instant event (``"ph": "i"``, thread scope) on the
        calling thread's track: a moment, such as a fit's start."""
        if not _host_time_ok():
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "pid": self.pid, "tid": self._tid(),
              "ts": self._us(time.perf_counter_ns())}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, **values) -> None:
        """A Chrome counter event (``"ph": "C"``) -- renders as a stacked
        area series in Perfetto."""
        if not _host_time_ok():
            return
        ev = {"name": name, "ph": "C", "pid": self.pid,
              "ts": self._us(time.perf_counter_ns()), "args": values}
        with self._lock:
            self._events.append(ev)

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
