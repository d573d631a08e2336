"""Carry a model's parameters, or a sampler's state, across from the JAX
package.

The two packages share no code, so parameters cross as numpy arrays: the
JAX ``TopicModel``'s ``.nwk``/``.nk`` (or its npz), a JAX ``FrozenModel``'s
four tables, and a JAX ``SamplerState``'s arrays (``nwk`` in its physical
cyclic layout), from which a sweep starts on the same state in both
packages.  Carrying the alias tables too matters: the
assignments of an alias table depend on the order its stacks were filled,
so only identical tables give identical fold-in chains -- which is what lets
a whole fold-in be compared bitwise between the packages.
"""
from __future__ import annotations

import torch

from repro_torch.api.model import (Device, TopicModel, as_tensor,
                                   cfg_from_dict, resolve_device)
from repro_torch import ps
from repro_torch.core.lightlda import FrozenModel, SamplerState


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


def sampler_state_from_arrays(w, d, z, valid, doc_start, doc_len, nwk_phys,
                              nk, ndk, cfg_dict: dict,
                              device: Device = None) -> SamplerState:
    """A port ``SamplerState`` holding exactly a JAX ``SamplerState``'s
    arrays: token arrays ``w``/``d``/``z``/``valid``, ``doc_start`` /
    ``doc_len``, ``nwk_phys`` (``state.nwk.value``, the physical cyclic
    layout), ``nk`` and ``ndk``; ``cfg_dict`` gives V and the shard
    count."""
    dev = resolve_device(device)
    cfg = cfg_from_dict(cfg_dict)
    client = ps.client_for(cfg)

    def i32(x):
        return as_tensor(x, dev).to(torch.int32)

    return SamplerState(i32(w), i32(d), i32(z),
                        as_tensor(valid, dev).to(torch.bool), i32(doc_start),
                        i32(doc_len),
                        client.wrap_matrix(i32(nwk_phys), num_rows=cfg.V),
                        client.wrap_vector(i32(nk)), i32(ndk))
