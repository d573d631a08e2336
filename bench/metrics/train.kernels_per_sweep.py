"""``train.kernels_per_sweep``: device operations (kernels, copies, fills)
in the traced window, divided by the sweeps in it."""
from __future__ import annotations

KERNELS = ("every kernel, memcpy and memset",)


def read(ctx):
    trace, sweeps = ctx.get("trace"), ctx.get("sweeps")
    if trace is None or not trace.device or not sweeps:
        return None
    return len(trace.device) / sweeps
