"""Counters, gauges, and HDR-style latency histograms (stdlib only).

The registry is the metrics half of the obs plane: spans answer *where
time went inside one operation*, the registry answers *what the
distribution over many operations looks like* -- per-request serving
latency p50/p95/p99, queue depth over time, batch occupancy.

``Histogram`` uses the HdrHistogram bucketing idea sized for latency in
milliseconds: log2 major buckets (via ``math.frexp``) with
``SUBBUCKETS`` linear sub-buckets per octave, giving a fixed ~3% relative
error on percentile queries over any dynamic range, in O(1) memory per
distinct octave and O(1) record cost.  Exact min/max/count/sum are kept
alongside so means and extremes are not quantised.

Everything dumps to JSONL (one metric per line) so downstream tooling --
reports, notebooks -- can stream-parse it.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

SUBBUCKETS = 16  # linear sub-buckets per power-of-two octave (~3% error)


def _bucket_of(value: float) -> int:
    """Map a positive value to its (octave, sub-bucket) key, linearised.

    ``frexp`` gives value = m * 2**e with m in [0.5, 1); the mantissa is
    split into ``SUBBUCKETS`` equal slices.  Monotonic in value.
    """
    m, e = math.frexp(value)
    sub = int((m - 0.5) * 2 * SUBBUCKETS)
    if sub >= SUBBUCKETS:  # m == 1.0 edge after float fuzz
        sub = SUBBUCKETS - 1
    return e * SUBBUCKETS + sub


def _bucket_upper(key: int) -> float:
    """Upper edge of a bucket key (inverse of ``_bucket_of``)."""
    e, sub = divmod(key, SUBBUCKETS)
    return math.ldexp(0.5 + (sub + 1) / (2 * SUBBUCKETS), e)


class Counter:
    """A monotonically increasing count (events, bytes, hits/misses)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self.value += amount

    def to_json(self) -> dict:
        return {"kind": "counter", "name": self.name, "value": self.value}


class Gauge:
    """A point-in-time value with a bounded time series (last ``keep``
    samples as ``(t_mono_s, value)``), e.g. queue depth, snapshot
    version."""

    __slots__ = ("name", "value", "series", "keep", "_lock")

    def __init__(self, name: str, keep: int = 4096):
        self.name = name
        self.value: float = 0.0
        self.series: List[Tuple[float, float]] = []
        self.keep = keep
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = value
            self.series.append((time.monotonic(), value))
            if len(self.series) > self.keep:
                del self.series[: len(self.series) - self.keep]

    def to_json(self) -> dict:
        with self._lock:
            return {"kind": "gauge", "name": self.name, "value": self.value,
                    "series": [[round(t, 6), v] for t, v in self.series]}


class Histogram:
    """HDR-style histogram; record in any unit (serving uses ms)."""

    __slots__ = ("name", "unit", "buckets", "count", "total", "vmin",
                 "vmax", "_lock")

    def __init__(self, name: str, unit: str = "ms"):
        self.name = name
        self.unit = unit
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        v = max(float(value), 1e-9)  # clamp zero/negatives to one tiny bucket
        key = _bucket_of(v)
        with self._lock:
            self.buckets[key] = self.buckets.get(key, 0) + 1
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in [0, 100]; bucket upper edge, clamped
        to the exact observed [min, max]."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = (q / 100.0) * self.count
            seen = 0
            for key in sorted(self.buckets):
                seen += self.buckets[key]
                if seen >= target:
                    return min(max(_bucket_upper(key), self.vmin), self.vmax)
            return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p95": self.percentile(95), "p99": self.percentile(99)}

    def to_json(self) -> dict:
        with self._lock:
            buckets = {str(k): v for k, v in sorted(self.buckets.items())}
        return {"kind": "histogram", "name": self.name, "unit": self.unit,
                **self.summary(), "buckets": buckets}


class MetricsRegistry:
    """Named metric instruments, created on first use; dumped as JSONL."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory(name)
                self._metrics[name] = m
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, unit: str = "ms") -> Histogram:
        return self._get(name, lambda n: Histogram(n, unit))

    def get(self, name: str) -> Optional[object]:
        with self._lock:
            return self._metrics.get(name)

    def all(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for name in sorted(self.all()):
                f.write(json.dumps(self._metrics[name].to_json(),
                                   sort_keys=True) + "\n")
        return path


def load_jsonl(path: str) -> List[dict]:
    """Parse a metrics JSONL dump back into dicts (``launch.obs_report``
    renders them)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
