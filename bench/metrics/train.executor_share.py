"""``train.executor_share``: the device time of the executor's own phases
(``exec.prologue``: owned copies, keys, the first pull; ``exec.gather``:
the group's gathers; ``exec.select``: the kept topics and the changed
mask; ``exec.write_z``) over the sweeps' device time (``sweep.device``),
all from CUDA events in the program's spans."""
from __future__ import annotations

from bench import spans

KERNELS = ()


def read(ctx):
    return spans.share(ctx, ("exec.prologue", "exec.gather", "exec.select",
                             "exec.write_z"))
