"""``train.delta_push_roofline``: the floor of the group-boundary merge
(``bench/counts``: the valid tokens' reads) over B3's device time in the
trace."""
from __future__ import annotations

from bench import trace as tr
from bench.counts import lda

KERNELS = ("delta_push_kernel",)


def read(ctx):
    return tr.roofline_share(ctx, KERNELS, lda.delta_push)
