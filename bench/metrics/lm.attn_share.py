"""``lm.attn_share``: the device time of attention, its forward
(``lm.attn``) and its backward (``lm.attn.bwd``), as a share of the steps'
(``lm.step.device``), from CUDA events in the program's spans on the
card."""
from __future__ import annotations

from bench import spans

KERNELS = ()
PARTS = ("lm.attn", "lm.attn.bwd")


def read(ctx):
    step = sum(e["dur"] for e in spans.on_card(ctx, "lm.step.device"))
    if step <= 0:
        return None
    return 100.0 * sum(e["dur"] for e in spans.on_card(ctx, *PARTS)) / step
