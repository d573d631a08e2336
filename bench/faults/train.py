"""The control and the faults of the ``train`` driver's cells, found by the
driver's name (``bench/faults/<driver>.py``).

``CONTROL`` gives, for each precision a configuration of this driver may
state, the dtype one below it in which the reference takes the program's
place (``bench/run.py --control``).  ``FAULTS`` are planted under the timed
path, one for each fault the cell can have: each replaces a function of the
program (``module, attribute, replacement``).  A run with the control or a
fault has to read ``correct`` false.  The benchmark's own runs plant
nothing: ``bench/control.py`` and ``bench/tests`` do."""
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


def half_the_batch(state, key, cfg, idx, bval, *args, block_counts=None,
                   **kw):
    """Half of every group's tokens left out: every other slot of a padded
    row is resampled, and a group that works its valid prefix alone works
    the first half of it."""
    keep = torch.zeros_like(bval)
    keep[:, ::2] = True
    if block_counts is not None:
        block_counts = [c // 2 for c in block_counts]
    return REAL(state, key, cfg, idx, bval & keep, *args,
                block_counts=block_counts, **kw)


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


CONTROL = {"float32": "bfloat16"}

# name -> (module, attribute, replacement)
FAULTS = {
    "init_other_key": (lda, "init_state", init_other_key),
    "unchanged": (async_exec, "pipelined_sweep", unchanged),
    "half_the_batch": (async_exec, "pipelined_sweep", half_the_batch),
    "merge_left_out": (async_exec, "pipelined_sweep", merge_left_out),
    "token_altered": (async_exec, "pipelined_sweep", token_altered),
}
