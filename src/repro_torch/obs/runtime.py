"""The process-wide obs session: config, installation, accessors.

Instrumented call sites throughout the codebase never construct tracers
themselves -- they ask this module:

    from repro_torch import obs
    with obs.span("snapshot.build", cat="snapshot") as sp:
        out = ...
        sp.sync_on(out)

``span`` / ``metrics`` return no-op objects unless an ``ObsSession`` is
installed (``obs.session(cfg)`` context manager, or ``ObsSession(cfg)
.install()``), so the disabled-mode cost at every call site is one module
attribute read and one ``is None`` check, with no call-site gating.

``ObsConfig`` is a **frozen, hashable** dataclass of primitives because it
rides on frozen component configs such as ``FoldInConfig``.  Component
configs use the *tri-state* convention:

  * ``obs=None``            -- inherit whatever session is installed;
  * ``ObsConfig(enabled=False)`` -- locally suppress even if a session is
    installed;
  * ``ObsConfig(enabled=True)``  -- request tracing (the owner of the run
    -- a server, a bench, a CLI -- installs the session).

Resolved via ``tracer_for(cfg)`` / ``metrics_for(cfg)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Iterator, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, Tracer


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Telemetry plane switchboard (frozen + hashable).

    ``sync_spans`` controls the device-sync boundary policy: when True
    (default), spans close with a device synchronise on their registered
    sync value so durations mean "work finished", not "work enqueued".
    Turning it off observes pure host dispatch cost instead.  Neither
    setting affects computed values.
    """

    enabled: bool = False
    out_dir: str = "experiments/obs"
    trace: bool = True
    metrics: bool = True
    sync_spans: bool = True
    trace_file: str = "trace.json"
    metrics_file: str = "metrics.jsonl"

    @property
    def trace_path(self) -> str:
        return os.path.join(self.out_dir, self.trace_file)

    @property
    def metrics_path(self) -> str:
        return os.path.join(self.out_dir, self.metrics_file)


class ObsSession:
    """One installed telemetry scope: owns the Tracer + MetricsRegistry
    and writes both files on close.  Install/uninstall is idempotent and
    reference-safe (nested sessions: innermost wins, outer restored)."""

    def __init__(self, cfg: ObsConfig):
        self.cfg = cfg
        self.tracer = Tracer(sync_spans=cfg.sync_spans) if cfg.trace else None
        self.metrics = MetricsRegistry() if cfg.metrics else None
        self._prev: Optional["ObsSession"] = None

    def install(self) -> "ObsSession":
        global _SESSION
        with _STATE_LOCK:
            self._prev = _SESSION
            _SESSION = self
        return self

    def close(self, save: bool = True) -> "ObsSession":
        global _SESSION
        with _STATE_LOCK:
            if _SESSION is self:
                _SESSION = self._prev
        if save:
            self.save()
        return self

    def save(self) -> None:
        if self.tracer is not None:
            self.tracer.save(self.cfg.trace_path)
        if self.metrics is not None:
            self.metrics.save(self.cfg.metrics_path)


_STATE_LOCK = threading.Lock()
_SESSION: Optional[ObsSession] = None


# -- global accessors (the call-site API) ---------------------------------

def active() -> Optional[ObsSession]:
    return _SESSION


def tracer() -> Optional[Tracer]:
    s = _SESSION
    return s.tracer if s is not None else None


def metrics_registry() -> Optional[MetricsRegistry]:
    s = _SESSION
    return s.metrics if s is not None else None


def span(name: str, cat: str = "host", sync: Any = None, **args):
    """Open a span on the installed tracer, or ``NULL_SPAN`` when none."""
    t = tracer()
    if t is None:
        return NULL_SPAN
    return t.span(name, cat=cat, sync=sync, **args)


def tracer_for(cfg: Optional[ObsConfig]) -> Optional[Tracer]:
    """Resolve a component's tri-state ``obs`` field against the session:
    None inherits, enabled=False suppresses, enabled=True inherits (the
    session install is the run owner's job)."""
    if cfg is not None and not cfg.enabled:
        return None
    return tracer()

def metrics_for(cfg: Optional[ObsConfig]) -> Optional[MetricsRegistry]:
    if cfg is not None and not cfg.enabled:
        return None
    return metrics_registry()


@contextlib.contextmanager
def session(cfg: Optional[ObsConfig]) -> Iterator[Optional[ObsSession]]:
    """Install an ``ObsSession`` for the duration of a run (and save its
    outputs on exit) when ``cfg.enabled``; otherwise a no-op scope.

    The standard run-owner idiom::

        with obs.session(job.obs):
            ... train / serve ...
    """
    if cfg is None or not cfg.enabled:
        yield None
        return
    s = ObsSession(cfg).install()
    try:
        yield s
    finally:
        s.close(save=True)
