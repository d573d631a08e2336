"""From a ``torch.profiler`` trace to the numbers the per-layer metrics read.

The profiler's Chrome trace holds the card's operations (kernels, copies,
fills) on the same clock as the host's operators and the harness's own
annotations.  The measured window is the harness's ``bench.window``
annotation; device operations are clipped to it.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

from bench.counts.peaks import floor_s

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"

Interval = Tuple[str, float, float]      # name, start us, end us


class Trace(NamedTuple):
    device: List[Interval]               # sorted by start, inside the window
    host: List[Interval]                 # sorted by start
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def kernel_base(name: str) -> str:
    """A device operation's bare name: a demangled ``void ns::f<...>(args)``
    becomes ``ns::f``, and a kernel of an anonymous namespace (the
    program's own) its bare ``f``."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip()


_FUNCTOR = re.compile(r"[^<]*<(?:\d+, )*([^<(,]+)")


def op_label(name: str) -> str:
    """``kernel_base``, and for PyTorch's generic elementwise kernels the
    operation they were instantiated for (``...elementwise_kernel:
    at::native::CUDAFunctor_add``)."""
    base = kernel_base(name)
    if not base.endswith("elementwise_kernel"):
        return base
    m = _FUNCTOR.match(name.replace("(anonymous namespace)::", ""))
    return f"{base}: {m.group(1).strip()}" if m else base


def parse(events: list, window_name: str = WINDOW) -> Optional[Trace]:
    """A ``Trace`` of Chrome-trace ``events``; None when the window
    annotation is missing."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "user_annotation"
           and e.get("name") == window_name]
    if not win:
        return None
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            start, end = max(start, lo), min(end, hi)
            if end > start:
                device.append((e["name"], start, end))
        elif cat in HOST_CATS and e.get("name") != window_name:
            host.append((e["name"], start, end))
    device.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return Trace(device, host, (lo, hi))


def load(path: str) -> Optional[Trace]:
    with open(path) as f:
        doc = json.load(f)
    return parse(doc.get("traceEvents", []))


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, merged."""
    out: List[List[float]] = []
    for _, s, e in trace.device:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e6


def device_s(trace: Trace, names) -> Optional[float]:
    """Seconds of the device operations whose bare name is in ``names``;
    None when there is none."""
    names = set(names)
    spans = [e - s for n, s, e in trace.device if kernel_base(n) in names]
    return sum(spans) / 1e6 if spans else None


def roofline_share(ctx: dict, kernels, work) -> Optional[float]:
    """A kernel's share of its roofline in percent: the floor of the work
    ``work(**ctx["shape"])`` counts for one sweep (``bench/counts``), times
    the sweeps, over the device time of ``kernels`` in the trace; None
    when the trace has none of them."""
    trace = ctx.get("trace")
    took = device_s(trace, kernels) if trace is not None else None
    if not took:
        return None
    return 100.0 * ctx["sweeps"] * floor_s(*work(**ctx["shape"])) / took


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def _host_at(trace: Trace, starts: List[float], t: float,
             look_back: int = 64) -> str:
    """The innermost host operation running at ``t``: of those that cover
    it, the one that started last (searched among the ``look_back`` that
    started last before ``t``)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        name, s, e = trace.host[j]
        if e > t:
            return name
    return "(no host operation)"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    device by the host operation that was running when each gap began,
    each as ``[name, seconds]``, the largest first."""
    ops = defaultdict(float)
    for name, s, e in trace.device:
        ops[op_label(name)] += (e - s) / 1e6
    starts = [s for _, s, _ in trace.host]
    gaps = defaultdict(float)
    for s, e in idle_gaps(trace):
        gaps[_host_at(trace, starts, s)] += (e - s) / 1e6
    return {key: [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])
                  [:top]]
            for key, d in (("device_ops", ops), ("idle_gaps", gaps))}
