"""Carry a model's parameters, or a sampler's state, across from the JAX
package.

The two packages share no code, so parameters cross as numpy arrays: the
JAX ``TopicModel``'s ``.nwk``/``.nk`` (or its npz), a JAX ``FrozenModel``'s
four tables, and a JAX ``SamplerState``'s arrays (``nwk`` in its physical
cyclic layout), from which a sweep starts on the same state in both
packages; and a JAX SPMD state (``init_distributed_state``'s stacked
per-worker arrays and the physical ``n_wk``) into one rank's state, from
which one SPMD sweep starts on the same state in both packages; and the
two Spark-LDA baselines' states (EM's responsibilities and expected
counts, online VB's λ and step), from which both packages iterate on the
same state; and an LM's parameters (the JAX ``init_params`` pytree, its
layer stacks ``[L, ...]``) into the port's ``Transformer``, from which both
packages compute the same logits, and back (``lm_arrays_from_params``), and
an LM's ``TrainState`` with its AdamW moments, from which both packages
take the same train steps; and an LM's parameters into one mesh rank's
blocks (``lm_shard_from_arrays``, and with its ZeRO moment blocks
``train_state_from_arrays``) and every rank's blocks back
(``lm_arrays_from_shards``; from the files a training mesh's ranks write,
``lm_arrays_from_dumps``).  Carrying the alias tables too matters: the
assignments of an alias table depend on the order its stacks were filled,
so only identical tables give identical fold-in chains -- which is what lets
a whole fold-in be compared bitwise between the packages.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.api.model import (Device, TopicModel, as_tensor,
                                   cfg_from_dict, resolve_device)
from repro_torch import ps
from repro_torch.core.lda_em import EMState
from repro_torch.core.lda_online import OnlineState
from repro_torch.core.lightlda import FrozenModel, SamplerState
from repro_torch.models import transformer as tfm
from repro_torch.models.transformer import Transformer
from repro_torch.sharding.specs import P

LAYER_STACKS = ("blocks", "dense_blocks", "cross_blocks")


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


def em_state_from_arrays(gamma, ndk, nwk, nk,
                         device: Device = None) -> EMState:
    """A port ``EMState`` holding exactly a JAX ``EMState``'s float32
    arrays."""
    dev = resolve_device(device)
    return EMState(*(as_tensor(x, dev).to(torch.float32)
                     for x in (gamma, ndk, nwk, nk)))


def online_state_from_arrays(lam, t, device: Device = None) -> OnlineState:
    """A port ``OnlineState`` holding exactly a JAX ``OnlineState``'s λ
    (float32 [K, V]) and step counter (int32 scalar)."""
    dev = resolve_device(device)
    return OnlineState(as_tensor(lam, dev).to(torch.float32),
                       as_tensor(t, dev).to(torch.int32).reshape(()))


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes, as jax exports it
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``.  bf16 becomes ``ml_dtypes.bfloat16`` where that
    package is installed (what jax hands numpy), else a 2-byte void array
    of the same bits; ``np.savez`` writes either as the JAX package's
    ``checkpoint.save`` writes a bf16 leaf (``|V2``)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return bits.view(np.dtype("V2"))
    return bits.view(ml_dtypes.bfloat16)


def _lm_state_from_tree(tree: dict) -> dict:
    """``{parameter name: tensor}`` (CPU) from a JAX LM pytree of numpy
    arrays (parameters, gradients or moments): a layer stack's ``[L, ...]``
    leaves become ``<stack>.<i>.<path>``, the rest ``<path>``."""
    state = {}

    def walk(path, sub):
        if isinstance(sub, dict):
            for name, child in sub.items():
                walk(path + (name,), child)
        elif path[0] in LAYER_STACKS:
            for i in range(sub.shape[0]):
                state[".".join((path[0], str(i)) + path[1:])] = \
                    _from_numpy(sub[i])
        else:
            state[".".join(path)] = _from_numpy(sub)

    walk((), tree)
    return state


def lm_params_from_arrays(params: dict, cfg, device: Device = None
                          ) -> Transformer:
    """The port's ``Transformer`` holding exactly a JAX LM's parameters:
    ``params`` is the JAX ``init_params`` pytree as nested dicts of numpy
    arrays; a layer stack's leaves are ``[L, ...]`` and layer ``i`` becomes
    ``<stack>.<i>.<path>`` of the module.  Every leaf must land on a
    parameter of the same shape and dtype, and every parameter must get
    one."""
    model = Transformer(cfg, device=device)
    state = _lm_state_from_tree(params)
    own = model.state_dict()
    for name, t in state.items():
        if name in own and own[name].dtype != t.dtype:
            raise ValueError(f"{name}: {t.dtype} where the model has "
                             f"{own[name].dtype}")
    model.load_state_dict(state, strict=True)
    return model


def lm_arrays_from_params(params) -> dict:
    """The inverse of ``lm_params_from_arrays``: the JAX ``init_params``
    pytree as nested dicts of numpy arrays, each layer stack's leaves
    restacked to ``[L, ...]``.  ``params`` is a ``Transformer`` or a dict
    ``{parameter name: tensor}`` -- its parameters, their gradients or an
    AdamW moment -- so any of them lands in the JAX package's layout (and
    ``train.checkpoint.save`` writes its keys)."""
    items = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    tree: dict = {}
    stacks: dict = {}

    def put(path, leaf):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    for name, t in items:
        path = tuple(name.split("."))
        if path[0] in LAYER_STACKS:
            stacks.setdefault((path[0],) + path[2:], {})[int(path[1])] = \
                _to_numpy(t)
        else:
            put(path, _to_numpy(t))
    for path, layers in stacks.items():
        put(path, np.stack([layers[i] for i in range(len(layers))]))
    return tree


def flat_tree(tree, path=()) -> dict:
    """A nested dict (``lm_arrays_from_params``' pytree) as ``{'/'-path:
    leaf}``."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def lm_shard_from_arrays(params: dict, cfg, ctx, rank: int,
                         device: Device = None,
                         layout_shards: int = 1) -> Transformer:
    """Mesh rank ``rank``'s ``Transformer`` (``ctx`` gives the mesh's
    shape) holding its blocks of a JAX LM's parameters.  ``params`` is the
    JAX ``init_params`` pytree of numpy arrays, made for a model axis of
    ``layout_shards`` (its vocab tables' and expert stacks' rows in that
    cyclic order: on a JAX mesh of that model size these rows are what
    each logical token and expert reads); the rows are permuted to the
    logical order and then to the mesh's."""
    model = Transformer(cfg, ctx, device, rank=rank)
    state = _lm_state_from_tree(params)
    own = dict(model.named_parameters())
    if set(state) != set(own):
        raise ValueError(f"leaves {sorted(set(state) ^ set(own))} are not "
                         "on both sides")
    with torch.no_grad():
        for name, t in state.items():
            if own[name].dtype != t.dtype:
                raise ValueError(f"{name}: {t.dtype} where the model has "
                                 f"{own[name].dtype}")
            logical = tfm.from_cyclic_rows(name, t, cfg, layout_shards)
            own[name].copy_(tfm.shard_leaf(name, logical, cfg, ctx, rank))
    return model


def lm_arrays_from_shards(shards, cfg, ctx, layout_shards: int = 1,
                          spec_of: dict = None) -> dict:
    """The inverse of ``lm_shard_from_arrays``: every rank's parameters
    (models or ``{name: tensor}`` dicts, in rank order) gathered into the
    JAX ``init_params`` pytree for a model axis of ``layout_shards`` (its
    padding rows zero).  ``spec_of`` (``{name: spec}``) places blocks cut
    otherwise than the rules cut the parameters: ZeRO moment blocks."""
    states = [dict(s.named_parameters()) if isinstance(s, torch.nn.Module)
              else s for s in shards]
    full = {}
    for name in states[0]:
        blocks = [st[name].detach().cpu() for st in states]
        logical = tfm.unshard_leaf(name, blocks, cfg, ctx,
                                   None if spec_of is None
                                   else spec_of[name])
        full[name] = tfm.to_cyclic_rows(name, logical, cfg, layout_shards)
    return lm_arrays_from_params(full)


def lm_arrays_from_dumps(path: str, kind: str, cfg, ctx) -> dict:
    """The JAX pytree of ``kind`` (``params``, ``m``, ``v``, ``grads``)
    from the files ``rank<r>.pt`` that a training mesh's ranks wrote
    (``train.mesh_worker``: each rank's blocks and their specs), read
    lazily (``mmap``) one leaf at a time."""
    dumps = [torch.load(os.path.join(path, f"rank{r}.pt"), mmap=True,
                        weights_only=True) for r in range(ctx.num_devices)]
    spec_of = {n: P(*s) for n, s in dumps[0]["specs"][kind].items()}
    return lm_arrays_from_shards([d[kind] for d in dumps], cfg, ctx,
                                 spec_of=spec_of)


def train_state_from_arrays(params: dict, opt_state, cfg,
                            device: Device = None, ctx=None):
    """A port ``TrainState`` holding exactly a JAX ``TrainState``'s
    parameters (``params``, the ``init_params`` pytree) and AdamW state
    (``opt_state``: its ``m`` and ``v`` pytrees, float32, and its int32
    ``step``; None: zero moments, step 0), all as numpy arrays.  With a
    mesh ``ctx`` (a rank's) the state of that rank: its parameter blocks
    (``lm_shard_from_arrays``) and its ZeRO blocks of the moments
    (``optimizer.Zero``)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import TrainState

    if ctx is None or ctx.mesh is None:
        model = lm_params_from_arrays(params, cfg, device)
        zero = None
    else:
        model = lm_shard_from_arrays(params, cfg, ctx, ctx.rank, device)
        zero = opt.Zero(model, ctx)
    dev = model.device
    names = dict(model.named_parameters())
    if opt_state is None:
        return TrainState(model, opt.init(names, zero))

    def moments(tree):
        flat = _lm_state_from_tree(tree)
        if set(flat) != set(names):
            raise ValueError("the moments' leaves are not the model's "
                             "parameters")
        if zero is None:
            return {n: flat[n].to(dev, torch.float32) for n in names}
        out = {}
        for n in names:
            logical = tfm.from_cyclic_rows(n, flat[n], cfg, 1)
            blk = tfm.shard_leaf(n, logical, cfg, ctx, ctx.rank)
            out[n] = zero.local(n, blk).to(dev, torch.float32).contiguous()
        return out

    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32)
    return TrainState(model, opt.AdamWState(
        moments(opt_state.m), moments(opt_state.v), step.to(dev)))
