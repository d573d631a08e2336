"""``train.ps_share``: the device time of the parameter server's copies
(``ps.pull``: a group's rows awaited and the next group's pulled;
``ps.store``: the rows written back) over the sweeps' device time
(``sweep.device``), from CUDA events in the program's spans."""
from __future__ import annotations

from bench import spans

KERNELS = ()


def read(ctx):
    return spans.share(ctx, ("ps.pull", "ps.store"))
