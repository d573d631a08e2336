"""``train.sweep_device_ms``: the median device time of the window's
sweeps, from the first to the last CUDA event of each (the program's
``sweep.device`` spans on the card)."""
from __future__ import annotations

import statistics

from bench import spans

KERNELS = ()


def read(ctx):
    sweeps = spans.on_card(ctx, "sweep.device")
    if not sweeps:
        return None
    return statistics.median(e["dur"] for e in sweeps) / 1e3
