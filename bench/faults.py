"""Faults planted under a training cell's timed path, one for each fault the
cell can have.  Each replaces a function of the program (``patch`` says
which); a run with it planted has to read ``correct`` false.  The benchmark's
own runs plant nothing: ``bench/control.py`` and ``bench/tests`` do."""
from __future__ import annotations

import torch

from repro_torch.core import lightlda as lda
from repro_torch.kernels import ops
from repro_torch.train import async_exec

REAL = async_exec.pipelined_sweep
REAL_INIT = lda.init_state


def init_other_key(key, *args, **kw):
    """The start broken: the initial topics drawn from another key."""
    return REAL_INIT(ops.fold_in(key, 1), *args, **kw)


def unchanged(state, key, cfg, *args, **kw):
    """A step that returns its state unchanged."""
    return state


def half_the_batch(state, key, cfg, idx, bval, *args, **kw):
    """Half of every group's tokens left out: only every other slot is
    resampled."""
    keep = torch.zeros_like(bval)
    keep[:, ::2] = True
    return REAL(state, key, cfg, idx, bval & keep, *args, **kw)


def merge_left_out(state, key, cfg, *args, **kw):
    """The merge left out (on one card the group-boundary merge is the
    exchange between the sampler and the parameter server): the topics
    move, the count tables do not."""
    out = REAL(state, key, cfg, *args, **kw)
    return lda.SamplerState(out.w, out.d, out.z, out.valid, out.doc_start,
                            out.doc_len, state.nwk, state.nk, state.ndk)


def token_altered(state, key, cfg, *args, **kw):
    """One token's topic altered where it is produced."""
    out = REAL(state, key, cfg, *args, **kw)
    z = out.z.clone()
    z[0] = (z[0] + 1) % cfg.K
    return out._replace(z=z)


# name -> (module, attribute, replacement)
FAULTS = {
    "init_other_key": (lda, "init_state", init_other_key),
    "unchanged": (async_exec, "pipelined_sweep", unchanged),
    "half_the_batch": (async_exec, "pipelined_sweep", half_the_batch),
    "merge_left_out": (async_exec, "pipelined_sweep", merge_left_out),
    "token_altered": (async_exec, "pipelined_sweep", token_altered),
}
