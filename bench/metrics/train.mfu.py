"""``train.mfu``: the whole sweep's floor (``bench/counts.lda.sweep``: the
larger of its int32 operations over the int32 peak and its bytes over the
memory bandwidth) times the sweeps, over the traced window."""
from __future__ import annotations

from bench.counts import lda, peaks

KERNELS = ()


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * ctx["sweeps"] * peaks.floor_s(
        *lda.sweep(**ctx["shape"])) / trace.window_s
