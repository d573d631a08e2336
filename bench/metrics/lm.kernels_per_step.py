"""``lm.kernels_per_step``: device operations (kernels, copies, fills) in
the traced window, divided by the training steps in it."""
from __future__ import annotations

KERNELS = ("every kernel, memcpy and memset",)


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps")
    if trace is None or not trace.device or not steps:
        return None
    return len(trace.device) / steps
