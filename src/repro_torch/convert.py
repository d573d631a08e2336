"""Carry a model's parameters, or a sampler's state, across from the JAX
package.

The two packages share no code, so parameters cross as numpy arrays: the
JAX ``TopicModel``'s ``.nwk``/``.nk`` (or its npz), a JAX ``FrozenModel``'s
four tables, and a JAX ``SamplerState``'s arrays (``nwk`` in its physical
cyclic layout), from which a sweep starts on the same state in both
packages; and a JAX SPMD state (``init_distributed_state``'s stacked
per-worker arrays and the physical ``n_wk``) into one rank's state, from
which one SPMD sweep starts on the same state in both packages.  Carrying
the alias tables too matters: the
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


def spmd_state_from_arrays(w, d, valid, doc_start, doc_len, z, ndk,
                           nwk_phys, nk, cfg_dict: dict, mesh,
                           device: Device = None) -> SamplerState:
    """Rank ``mesh.rank``'s ``SamplerState`` from a JAX SPMD state:
    ``init_distributed_state``'s stacked ``[workers, ...]`` arrays (row
    ``rank`` is this rank's), ``nwk_phys`` the full physical table (of
    which this rank keeps its server's rows), ``nk``.  The count handles
    ride an SPMD client over ``mesh`` (``cfg_dict``'s shard count is the
    mesh's model axis).  ``device``: None is the mesh's."""
    dev = mesh.device if device is None else resolve_device(device)
    cfg = cfg_from_dict(cfg_dict)
    if cfg.num_shards != mesh.model:
        raise ValueError(f"the state has {cfg.num_shards} PS shards; the "
                         f"mesh's model axis has {mesh.model}")
    client = ps.client_for(cfg, mesh=mesh, axis_name=("data", "model"),
                           model_axis="model")
    r = mesh.rank
    rps = nwk_phys.shape[0] // mesh.model
    i = mesh.model_idx

    def i32(x):
        return as_tensor(x, dev).to(torch.int32)

    return SamplerState(i32(w[r]), i32(d[r]), i32(z[r]),
                        as_tensor(valid[r], dev).to(torch.bool),
                        i32(doc_start[r]), i32(doc_len[r]),
                        client.wrap_matrix(i32(nwk_phys[i * rps:
                                                        (i + 1) * rps]),
                                           num_rows=cfg.V),
                        client.wrap_vector(i32(nk)), i32(ndk[r]))
