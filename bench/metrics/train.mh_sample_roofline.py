"""``train.mh_sample_roofline``: the sampler's floor (``bench/counts``, its
valid tokens only) over its device time in the trace."""
from __future__ import annotations

from bench import trace as tr
from bench.counts import lda

KERNELS = ("mh_sample_kernel", "mh_sample_loop_kernel")


def read(ctx):
    return tr.roofline_share(ctx, KERNELS, lda.mh_sample)
