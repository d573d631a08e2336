"""``train.mh_draws_roofline``: the floor of the chain's randoms
(``bench/counts``: threefry hashes of the valid tokens, by the int32 peak)
over the draws kernel's device time in the trace."""
from __future__ import annotations

from bench import trace as tr
from bench.counts import lda

KERNELS = ("mh_draws_train_kernel",)


def read(ctx):
    return tr.roofline_share(ctx, KERNELS, lda.mh_draws)
