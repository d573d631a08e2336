"""``lm.mfu``: the model FLOPs of the window's steps (``bench/counts/
deepseek_v2.step_flops``: three times the forward's products at the cut
widths, causal attention, the (token, held expert) pairs the program
counted, ``lm.moe.held_pairs``) over the traced window times the card's
bf16 tensor-core peak."""
from __future__ import annotations

from bench.counts import deepseek_v2, peaks

KERNELS = ("every kernel of the step",)


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps")
    pairs = [e["args"]["pairs"] for e in ctx.get("spans") or []
             if e.get("ph") == "C" and e.get("name") == "lm.moe.held_pairs"]
    if trace is None or not trace.device or trace.window_s <= 0 \
            or not steps or len(pairs) != steps:
        return None
    shape = ctx["shape"]
    flops = sum(deepseek_v2.step_flops(shape["config"], shape["rows"],
                                       shape["seq_len"], p) for p in pairs)
    return 100.0 * flops / (trace.window_s * peaks.BF16_FLOPS_PER_S)
