"""The program's own spans of the card's phases, as the per-layer readers
take them: ``repro_torch``'s pipelined sweep marks each phase with CUDA
events and puts it on its tracer's ``[device]`` lane with ``cat`` "cuda"
(``sweep.device``, ``exec.group``, ``exec.prologue`` and the nine phases
of a group).  A run on the CPU, or a program without them, has none."""
from __future__ import annotations

from typing import List, Optional


def on_card(ctx: dict, *names: str) -> List[dict]:
    """The spans called one of ``names`` that the program timed on the
    card, from ``ctx["spans"]`` (its tracer's events)."""
    return [e for e in ctx.get("spans") or []
            if e.get("ph") == "X" and e.get("cat") == "cuda"
            and e.get("name") in names]


def share(ctx: dict, names) -> Optional[float]:
    """The device time of the phases ``names`` as a percentage of the
    sweeps' (``sweep.device``); None when there is no sweep."""
    sweep = sum(e["dur"] for e in on_card(ctx, "sweep.device"))
    if sweep <= 0:
        return None
    return 100.0 * sum(e["dur"] for e in on_card(ctx, *names)) / sweep
