"""``lm.optimizer_share``: the device time of the optimizer (AdamW over
every leaf, ``lm.optimizer``), as a share of the steps'
(``lm.step.device``), from CUDA events in the program's spans on the
card."""
from __future__ import annotations

from bench import spans

KERNELS = ()
PARTS = ("lm.optimizer",)


def read(ctx):
    step = sum(e["dur"] for e in spans.on_card(ctx, "lm.step.device"))
    if step <= 0:
        return None
    return 100.0 * sum(e["dur"] for e in spans.on_card(ctx, *PARTS)) / step
