"""The control and the faults of the ``lm_train`` driver's cells, found by
the driver's name (``bench/faults/<driver>.py``).

``CONTROL`` gives, for each precision a configuration of this driver may
state, the dtype one below it in which the reference takes the program's
place (``bench/run.py --control``).  ``FAULTS`` are planted under the timed
path, one for each part of the published model a step could lose: each
replaces a function of the program (``module, attribute, replacement``).
A run with the control or a fault has to read ``correct`` false."""
from __future__ import annotations

import torch

from repro_torch.models import attention, layers, moe
from repro_torch.train import optimizer

REAL_ROUTE = moe._route
REAL_PAIRS = moe.held_pairs


def gates_normalized(m, x, cfg, router=None):
    """The top-k gates renormalised to sum to 1 (the registry twin's
    router), whatever the configuration says."""
    gates, ids, probs = REAL_ROUTE(m, x, cfg, router)
    if not cfg.norm_topk_prob:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids, probs


def yarn_left_out(cfg, dim, theta, device=None):
    """Plain RoPE and the plain softmax scale."""
    return layers.Rope(layers.rope_freqs(dim, theta, device), 1.0, 1.0)


def held_expert_left_out(ids, cfg):
    """The last held expert's pairs dropped."""
    pairs, counts = REAL_PAIRS(ids, cfg)
    return pairs[:len(pairs) - counts[-1]], counts[:-1] + [0]


def shared_left_out(mlp, x, act):
    """The shared experts add nothing."""
    return torch.zeros_like(x)


def step_skipped(grads, state, params, tc, *zero):
    """The optimizer leaves the parameters and the moments unchanged."""
    return params, state, {"lr": torch.zeros(()), "grad_norm":
                           torch.zeros(())}


CONTROL = {"bfloat16": "float8_e4m3fn"}

# name -> (module, attribute, replacement)
FAULTS = {
    "gates_normalized": (moe, "_route", gates_normalized),
    "yarn_left_out": (attention, "rope_for", yarn_left_out),
    "held_expert_left_out": (moe, "held_pairs", held_expert_left_out),
    "shared_left_out": (moe, "apply_mlp", shared_left_out),
    "step_skipped": (optimizer, "apply", step_skipped),
}
