"""The shared timer: one methodology for every timed loop of the port.

``time_loop`` fixes how a loop is timed, as the JAX package's does:

  * ``perf_counter_ns`` (monotonic, highest resolution);
  * an optional warmup call *outside* the window -- on the card the first
    launch of a kernel builds its ``csrc/*.cu`` source, and that build must
    never land in a timed repeat;
  * an explicit device synchronise **inside** the window, on every CUDA
    device that holds a tensor of ``sync(carry)`` -- the measured interval
    always means "work finished";
  * best-of-``repeats``;
  * when an obs session is installed, each repeat is recorded as a
    ``bench.<label>`` span, so traces and timings share one clock.

The loop shape is ``carry = step(carry, i)`` with ``i`` the *global*
iteration index (continuous across repeats), so a loop that derives a key
from ``i`` keeps its exact key sequence.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, List, Optional

from repro_torch.obs import runtime as _rt


@dataclasses.dataclass
class TimerResult:
    """Per-repeat wall times for ``iters`` iterations each."""

    label: str
    iters: int
    times_s: List[float]

    @property
    def best_s(self) -> float:
        return min(self.times_s)

    @property
    def mean_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    def best_rate(self, units_per_iter: float = 1.0) -> float:
        """Units per second at the best repeat (e.g. tokens/s, pushes/s)."""
        return units_per_iter * self.iters / self.best_s

    def ms_per_iter(self) -> float:
        return self.best_s / self.iters * 1e3


def cuda_devices(value: Any) -> set:
    """The CUDA devices of every tensor in ``value``, a tensor or nested
    tuples, lists and dicts of them (anything else holds none)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return set()
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return set().union(*(cuda_devices(v) for v in value))
    return set()


def synchronize(value: Any) -> None:
    """Wait until the devices holding ``value``'s tensors are done."""
    torch = sys.modules.get("torch")
    for dev in cuda_devices(value):
        torch.cuda.synchronize(dev)


def time_loop(step: Callable[[Any, int], Any], carry: Any, iters: int, *,
              repeats: int = 1, warmup: bool = True,
              sync: Optional[Callable[[Any], Any]] = None,
              label: str = "loop") -> tuple:
    """Time ``iters`` calls of ``carry = step(carry, i)``, best of
    ``repeats``; returns ``(carry, TimerResult)``.

    ``sync(carry)`` names the value whose completion closes the timing
    window (default: the carry itself); a value that holds no CUDA tensor
    closes it at once.  ``warmup`` runs one extra synchronised call before
    the first window.
    """
    if iters <= 0 or repeats <= 0:
        raise ValueError(f"iters and repeats must be positive (got {iters}, "
                         f"{repeats})")

    def _sync(c):
        synchronize(sync(c) if sync is not None else c)

    i = 0
    if warmup:
        carry = step(carry, i)
        i += 1
        _sync(carry)
    times = []
    tr = _rt.tracer()
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for _ in range(iters):
            carry = step(carry, i)
            i += 1
        _sync(carry)
        t1 = time.perf_counter_ns()
        times.append((t1 - t0) / 1e9)
        if tr is not None:
            tr.complete(f"bench.{label}", t0, t1, cat="bench", iters=iters)
    return carry, TimerResult(label=label, iters=iters, times_s=times)
