"""``train.dispatch_share``: the share of each sweep's time that the host
spends enqueueing it, from the program's own spans (``exec.dispatch`` ends
when the step returns, ``exec.sweep`` when a synchronise on the new ``z``
returns), summed over the window."""
from __future__ import annotations

KERNELS = ()


def read(ctx):
    spans = ctx.get("spans") or []
    dispatch = sum(e["dur"] for e in spans if e.get("name") == "exec.dispatch")
    sweep = sum(e["dur"] for e in spans if e.get("name") == "exec.sweep")
    return 100.0 * dispatch / sweep if sweep > 0 else None
