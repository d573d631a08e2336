"""``lm.device_idle``: the traced window less the union of the device's
operations, as a share of the window."""
from __future__ import annotations

from bench import trace as tr

KERNELS = ("every kernel, memcpy and memset",)


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s(trace) / trace.window_s)
