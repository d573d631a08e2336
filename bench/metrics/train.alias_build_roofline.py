"""``train.alias_build_roofline``: the floor of the word-proposal tables of
every row of ``n_wk`` (``bench/counts``) over B2's device time in the
trace."""
from __future__ import annotations

from bench import trace as tr
from bench.counts import lda

KERNELS = ("alias_build_kernel",)


def read(ctx):
    return tr.roofline_share(ctx, KERNELS, lda.alias_build)
