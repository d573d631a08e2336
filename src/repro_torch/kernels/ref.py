"""Plain PyTorch versions of the hand-written kernels (the ``ref.py``
contract): the same functions, on the same arguments, written as tensor
code.  The CPU path runs them; on the card they are what each kernel is
held against."""
from __future__ import annotations

import torch

from repro_torch.core import alias as alias_mod
from repro_torch.core import lightlda as lda


def mh_sample_ref(rng: "lda.MHRandoms", z0, w, d, nwk, ndk, nk, aprob,
                  aalias, cfg: "lda.LDAConfig",
                  frozen: bool = False) -> torch.Tensor:
    """Plain version of ``kernels/mh_sample.py``: gather each token's rows
    by index, then run the vectorised MH chain."""
    wl, dl = w.long(), d.long()
    return lda.mh_chain(rng, z0, nwk[wl], ndk[dl], nk, aprob[wl], aalias[wl],
                        cfg, frozen=frozen)


def alias_build_ref(weights: torch.Tensor) -> "alias_mod.AliasTable":
    """Plain version of ``kernels/alias_build.py``: Vose construction."""
    return alias_mod.build_alias_rows(weights)
