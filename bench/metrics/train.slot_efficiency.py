"""``train.slot_efficiency``: the valid tokens over the slots that the
window's groups drew, sampled and merged (each group's row of the token
index has the hottest group's capacity), from the args of the program's
``exec.group`` spans on the card (``tokens``, ``slots``)."""
from __future__ import annotations

from bench import spans

KERNELS = ()


def read(ctx):
    groups = spans.on_card(ctx, "exec.group")
    slots = sum(e["args"]["slots"] for e in groups)
    if slots <= 0:
        return None
    return 100.0 * sum(e["args"]["tokens"] for e in groups) / slots
