"""Carry a model's parameters across from the JAX package.

The two packages share no code, so parameters cross as numpy arrays: the
JAX ``TopicModel``'s ``.nwk``/``.nk`` (or its npz), and a JAX
``FrozenModel``'s four tables.  Carrying the alias tables too matters: the
assignments of an alias table depend on the order its stacks were filled,
so only identical tables give identical fold-in chains -- which is what lets
a whole fold-in be compared bitwise between the packages.
"""
from __future__ import annotations

import torch

from repro_torch.api.model import (Device, TopicModel, as_tensor,
                                   cfg_from_dict, resolve_device)
from repro_torch.core.lightlda import FrozenModel


def topic_model_from_arrays(nwk, nk, cfg_dict: dict,
                            device: Device = None) -> TopicModel:
    """A port ``TopicModel`` from a JAX model's counts and config dict
    (``dataclasses.asdict`` of its ``LDAConfig``, or an npz's ``cfg``)."""
    return TopicModel(nwk, nk, cfg_from_dict(cfg_dict), device=device)


def frozen_model_from_arrays(nwk, nk, aprob, aalias,
                             device: Device = None) -> FrozenModel:
    """A port ``FrozenModel`` holding exactly a JAX ``FrozenModel``'s
    tables (float32 counts, float32/int32 alias rows)."""
    dev = resolve_device(device)
    return FrozenModel(as_tensor(nwk, dev).to(torch.float32),
                       as_tensor(nk, dev).to(torch.float32),
                       as_tensor(aprob, dev).to(torch.float32),
                       as_tensor(aalias, dev).to(torch.int32))
