"""``lm.moe_share``: the device time of the MoE layers, their forward parts
(``lm.moe.route``: routing and grouping; ``lm.moe.experts``: the routed and
shared experts' products; ``lm.moe.combine``) and their backward
(``lm.moe.bwd``, inside which the layer's rematerialised forward runs
again), as a share of the steps' (``lm.step.device``), from CUDA events in
the program's spans on the card."""
from __future__ import annotations

from bench import spans

KERNELS = ()
PARTS = ("lm.moe.route", "lm.moe.experts", "lm.moe.combine", "lm.moe.bwd")


def read(ctx):
    step = sum(e["dur"] for e in spans.on_card(ctx, "lm.step.device"))
    if step <= 0:
        return None
    return 100.0 * sum(e["dur"] for e in spans.on_card(ctx, *PARTS)) / step
