"""``lm.step_device_ms``: the median device time of the window's training
steps, from the first to the last CUDA event of each (the program's
``lm.step.device`` spans on the card)."""
from __future__ import annotations

import statistics

from bench import spans

KERNELS = ()


def read(ctx):
    steps = spans.on_card(ctx, "lm.step.device")
    if not steps:
        return None
    return statistics.median(e["dur"] for e in steps) / 1e3
