"""The ``(data, model)`` mesh of the SPMD parameter server, on
``torch.distributed``.

The port's counterpart of the JAX package's ``jax.make_mesh((data, model),
("data", "model"))`` (``repro/launch/mesh.py``) and of the session's
``_resolve_mesh``.  One process per rank; ranks are laid out row-major, as
``shard_map`` flattens ``P(("data", "model"))``::

    rank = data_idx * model + model_idx

Every rank creates the same groups, in the same order:

  * the world: the worker axes ``("data", "model")`` -- the push's sum;
  * one ``model`` subgroup per data row: the servers that together hold one
    copy of ``n_wk`` in cyclic row shards -- the snapshot pull's
    all-gather;
  * one ``data`` subgroup per model column -- the first all-gather of a
    coordinate push (``SpmdBackend.gather_concat``);
  * a gloo ``control`` group over the world, on which rank 0 broadcasts the
    op code of each step of its command loop.

**The transport** follows from the layout alone, never from a failure:

  * ``"nccl"`` -- every rank has a card of its own (``devices <=
    torch.cuda.device_count()``): rank ``r`` runs on ``cuda:r`` and the
    collectives run on the cards;
  * ``"gloo"`` -- ranks share a card (NCCL refuses two ranks on one GPU),
    or run on the CPU.  gloo takes the card's tensors as they are and
    moves them through host memory itself.

Each collective's host milliseconds are added to ``Mesh.stats`` under the
caller's tag, its bytes (what this rank sends) to ``Mesh.bytes`` and its
count to ``Mesh.calls``.  Under gloo on the card the mesh synchronises the
device before and after each call, so the time is the collective's own;
NCCL's are the host's enqueue times.

**Host staging.**  ``all_to_all`` under gloo on card tensors copies the
send buffer into pinned host memory, exchanges it there and copies the
result back: the transport, not a failure, decides it.  Data moves as
bytes (``uint8`` views), so any dtype crosses unchanged; sums
(``all_reduce``) run in the tensor's own dtype.

The LM's mesh (``ctx_for``, ``make_host_mesh``) is the same ``Mesh``: the
JAX package's ``launch/mesh.py`` builds ``jax.make_mesh((data, model),
("data", "model"))`` over the local devices; here ``make_host_mesh``
returns the ``MeshLayout`` and each rank joins it with ``Mesh.init``.
"""
from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs as _obs

TRANSPORTS = ("nccl", "gloo")
WORLD = ("data", "model")
AxisName = Union[str, Tuple[str, ...]]

@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """The shape of a ``data x model`` mesh without its ranks: what the
    rules (``sharding.specs``) read, like a ``jax.sharding.Mesh``'s
    ``axis_names`` and ``devices.shape``."""

    data: int
    model: int
    axis_names: Tuple[str, ...] = WORLD

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.data * self.model).reshape(self.data,
                                                         self.model)


def make_host_mesh(model: int = 1, data: Optional[int] = None,
                   devices: Optional[int] = None) -> MeshLayout:
    """A small mesh over the cards that exist (``devices`` ranks when
    given: ranks may share a card, or run on the CPU); ``data`` defaults
    to ``devices // model``, as the reference's does."""
    n = int(devices) if devices else max(torch.cuda.device_count(), 1)
    d, m = resolve_mesh(n, model)
    if data is not None and int(data) != d:
        raise ValueError(f"data={data} x model={model} is not the {n} "
                         f"devices")
    return MeshLayout(d, m)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production pods, (data=16, model=16) = 256 chips or
    (pod=2, data=16, model=16) = 512: a TPU pod layout with no host
    counterpart (the port serves and trains on a host mesh of the local
    cards); ``repro_torch.launch.dryrun`` gives a rank's bytes on it."""
    shape = "2 x 16 x 16 (512 chips)" if multi_pod else "16 x 16 (256 chips)"
    raise NotImplementedError(
        f"the production mesh {shape} is the JAX package's TPU pod layout, "
        "which has no host counterpart: the port serves and trains on a "
        "host mesh of the local cards (--mesh host, make_host_mesh); "
        "python -m repro_torch.launch.dryrun gives the bytes a rank holds "
        "on the pod mesh")


def ctx_for(mesh):
    """``MeshCtx`` with dp = every non-model axis."""
    from repro_torch.sharding.specs import MeshCtx
    axes = tuple(mesh.axis_names)
    dp = tuple(a for a in axes if a != "model")
    model = "model" if "model" in axes else None
    return MeshCtx(mesh, dp, model)


def resolve_mesh(devices: int, mesh_model: int) -> Tuple[int, int]:
    """``(data, model)`` for ``devices`` ranks with ``mesh_model`` servers;
    raises the JAX package's divisibility error, whose remedy here is the
    rank count (``devices=``)."""
    n_dev, model = int(devices), int(mesh_model)
    if model < 1 or n_dev < 1 or n_dev % model:
        raise ValueError(
            f"device count {n_dev} is not divisible by "
            f"mesh_model={model}; adjust mesh_model or pass devices=N "
            f"(the number of ranks, a multiple of mesh_model)")
    return n_dev // model, model


def transport_for(devices: int, device: torch.device) -> str:
    """The collective transport of a mesh of ``devices`` ranks whose
    caller runs on ``device``: NCCL when every rank has its own card, gloo
    when ranks share one or run on the CPU."""
    if device.type == "cuda" and devices <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(transport: str, device: torch.device,
                rank: int) -> torch.device:
    """Where rank ``rank`` runs: ``cuda:rank`` under NCCL, the caller's
    device otherwise (the shared card, or the CPU)."""
    if transport == "nccl":
        return torch.device("cuda", rank)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _ranks_in_order(data: int, model: int):
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]
    return rows, cols


class Mesh:
    """This process's place in a ``data x model`` mesh, its groups and its
    collectives.  Build with ``Mesh.init`` (every rank, same arguments but
    ``rank``); ``close`` leaves the process group."""

    def __init__(self, data: int, model: int, rank: int, transport: str,
                 device: torch.device, groups: dict):
        self.data = data
        self.model = model
        self.rank = rank
        self.transport = transport
        self.device = device
        self._groups = groups
        self.stats: Dict[str, float] = {}
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}
        self._pinned: Dict[str, torch.Tensor] = {}

    # -- construction ------------------------------------------------------
    @classmethod
    def init(cls, rank: int, data: int, model: int, transport: str,
             device: torch.device, store_path: str,
             timeout_s: float = 600.0) -> "Mesh":
        """Join the process group through a ``FileStore`` at
        ``store_path`` and create every group; every wait is bounded by
        ``timeout_s``."""
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}; valid: "
                             f"{', '.join(TRANSPORTS)}")
        if dist.is_initialized():
            raise RuntimeError("this process is already in a "
                               "torch.distributed process group; an SPMD "
                               "run creates its own")
        world = data * model
        timeout = datetime.timedelta(seconds=timeout_s)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if transport == "nccl" else "gloo",
            store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timeout)
        rows, cols = _ranks_in_order(data, model)
        model_groups = [dist.new_group(r, timeout=timeout) for r in rows]
        data_groups = [dist.new_group(c, timeout=timeout) for c in cols]
        control = dist.new_group(list(range(world)), timeout=timeout,
                                 backend="gloo")
        d_idx, m_idx = rank // model, rank % model
        groups = {"world": dist.group.WORLD, "model": model_groups[d_idx],
                  "data": data_groups[m_idx], "control": control}
        if transport == "nccl":
            # NCCL makes a group's communicator at its first collective:
            # make them here, so that set-up, not the first sweep, pays
            for name in ("world", "model", "data"):
                dist.all_reduce(torch.zeros(1, device=device),
                                group=groups[name])
            torch.cuda.synchronize(device)
        return cls(data, model, rank, transport, device, groups)

    def close(self) -> None:
        """Leave the process group (idempotent)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    # -- coordinates -------------------------------------------------------
    @property
    def world(self) -> int:
        return self.data * self.model

    axis_names = WORLD

    @property
    def devices(self) -> np.ndarray:
        """Rank ids shaped ``(data, model)``, row-major."""
        return np.arange(self.world).reshape(self.data, self.model)

    @property
    def data_idx(self) -> int:
        return self.rank // self.model

    @property
    def model_idx(self) -> int:
        return self.rank % self.model

    def axis_index(self, axis: AxisName) -> int:
        """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
        return {"data": self.data_idx, "model": self.model_idx,
                WORLD: self.rank}[_axis(axis)]

    def axis_size(self, axis: AxisName) -> int:
        return {"data": self.data, "model": self.model,
                WORLD: self.world}[_axis(axis)]

    def _group(self, axis: AxisName):
        return self._groups[{"data": "data", "model": "model",
                             WORLD: "world"}[_axis(axis)]]

    # -- collectives -------------------------------------------------------
    def _run(self, fn, out: torch.Tensor, inp: torch.Tensor, axis,
             tag: str) -> torch.Tensor:
        group = self._group(axis)
        timed = self.transport == "gloo" and inp.is_cuda
        if timed:
            torch.cuda.synchronize(inp.device)
        t0 = time.perf_counter()
        with _obs.span(f"spmd.{tag}", cat="spmd", axis=str(axis),
                       bytes=inp.numel() * inp.element_size()):
            fn(out, inp, group)
            if timed:
                torch.cuda.synchronize(inp.device)
        self.stats[tag] = (self.stats.get(tag, 0.0)
                           + (time.perf_counter() - t0) * 1e3)
        self.bytes[tag] = (self.bytes.get(tag, 0)
                           + inp.numel() * inp.element_size())
        self.calls[tag] = self.calls.get(tag, 0) + 1
        return out

    def reset_stats(self) -> None:
        self.stats.clear()
        self.bytes.clear()
        self.calls.clear()

    def all_gather(self, x: torch.Tensor, axis: AxisName,
                   tag: str = "all_gather") -> torch.Tensor:
        """Tiled all-gather along dim 0 over ``axis``: every rank's ``x``
        concatenated in the axis's index order (2-byte and bool dtypes
        move as bytes)."""
        if x.dtype in (torch.bfloat16, torch.float16, torch.bool):
            return self.all_gather_dim(x, axis, 0, tag)
        x = x.contiguous()
        out = x.new_empty((self.axis_size(axis) * x.shape[0],
                           *x.shape[1:]))
        return self._run(lambda o, i, g: _all_gather(o, i, g), out, x, axis,
                         tag)

    def all_gather_dim(self, x: torch.Tensor, axis: AxisName, dim: int,
                       tag: str = "all_gather") -> torch.Tensor:
        """Tiled all-gather along ``dim``: the blocks of ``axis``'s ranks
        concatenated there in index order; moved as bytes."""
        if self.axis_size(axis) == 1:
            return x
        x = x.movedim(dim, 0).contiguous()
        raw = _as_bytes(x)
        out = raw.new_empty((self.axis_size(axis) * raw.shape[0],
                             raw.shape[1]))
        self._run(lambda o, i, g: _all_gather(o, i, g), out, raw, axis, tag)
        out = out.view(x.dtype).view(-1, *x.shape[1:])
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, axis: AxisName = "model",
                   tag: str = "all_to_all") -> torch.Tensor:
        """Block ``j`` of ``x``'s dim 0 (``n`` equal blocks, ``n`` the
        axis size) goes to the axis's rank ``j``; the result holds the
        blocks received, in rank order (``jax.lax.all_to_all`` with
        ``split_axis = concat_axis = 0``).  Moved as bytes; under gloo a
        card tensor is staged through pinned host memory."""
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: {x.shape[0]} rows do not split "
                             f"over {n} ranks")
        if n == 1:
            return x
        x = x.contiguous()
        raw = _as_bytes(x)
        stage = self.transport == "gloo" and raw.is_cuda
        t0 = time.perf_counter()
        send = self._host(f"{tag}.send", raw) if stage else raw
        recv = torch.empty_like(send)
        t1 = time.perf_counter()
        self._run(lambda o, i, g: dist.all_to_all_single(o, i, group=g),
                  recv, send, axis, tag)
        if stage:
            t2 = time.perf_counter()
            recv = raw.new_empty(raw.shape).copy_(recv)
            torch.cuda.synchronize(recv.device)
            key = f"{tag}.staging"
            self.stats[key] = self.stats.get(key, 0.0) + (
                t1 - t0 + time.perf_counter() - t2) * 1e3
        return recv.view(x.dtype).view(x.shape)

    def _host(self, key: str, raw: torch.Tensor) -> torch.Tensor:
        """``raw`` copied into a pinned host buffer kept for ``key``."""
        buf = self._pinned.get(key)
        if buf is None or buf.shape != raw.shape:
            buf = torch.empty(raw.shape, dtype=raw.dtype, pin_memory=True)
            self._pinned[key] = buf
        buf.copy_(raw)
        torch.cuda.synchronize(raw.device)
        return buf

    def all_reduce(self, x: torch.Tensor, axis: AxisName,
                   tag: str = "all_reduce") -> torch.Tensor:
        """Elementwise sum over ``axis`` (a new tensor; ``x`` is kept)."""
        out = x.contiguous().clone()
        return self._run(lambda o, i, g: dist.all_reduce(o, group=g), out,
                         out, axis, tag)

    def broadcast(self, x: torch.Tensor,
                  tag: str = "broadcast") -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place."""
        return self._run(lambda o, i, g: dist.broadcast(o, 0, group=g), x,
                         x, WORLD, tag)

    def barrier(self) -> None:
        """Every rank has reached this point (control group)."""
        dist.barrier(group=self._groups["control"])

    def reduce_scatter(self, x: torch.Tensor, axis: AxisName,
                       tag: str = "reduce_scatter") -> torch.Tensor:
        """Sum over ``axis``, scattered tiled along dim 0: this rank keeps
        rows ``[i*n, (i+1)*n)`` of the sum, ``i`` its index on the axis."""
        x = x.contiguous()
        n = self.axis_size(axis)
        if x.shape[0] % n:
            raise ValueError(f"reduce_scatter: {x.shape[0]} rows do not "
                             f"split over {n} ranks")
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        return self._run(lambda o, i, g: _reduce_scatter(o, i, g), out, x,
                         axis, tag)

    # -- the command loop's op codes ----------------------------------------
    def send_op(self, op: int, arg: int = 0) -> None:
        """Rank 0: broadcast one op code and its integer argument."""
        dist.broadcast(torch.tensor([op, arg], dtype=torch.int64), 0,
                       group=self._groups["control"])

    def recv_op(self) -> Tuple[int, int]:
        """Any other rank: wait (bounded by the group's timeout) for rank
        0's next op code; returns ``(op, arg)``."""
        msg = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(msg, 0, group=self._groups["control"])
        return tuple(msg.tolist())

    def broadcast_object(self, obj=None):
        """Rank 0's picklable ``obj`` on every rank (control group)."""
        box = [obj]
        dist.broadcast_object_list(box, 0, group=self._groups["control"])
        return box[0]

    def gather_object(self, obj) -> Optional[list]:
        """Every rank's ``obj`` in rank order on rank 0 (None elsewhere)."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, 0, group=self._groups["control"])
        return out

    def __repr__(self):
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank}, transport={self.transport!r}, "
                f"device={self.device})")


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes, ``[rows, row bytes]`` (uint8)."""
    rows = x.shape[0] if x.dim() else 1
    return x.contiguous().view(-1).view(torch.uint8).view(rows, -1)


def _axis(axis: AxisName):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
        if axis == WORLD:
            return WORLD
        if len(axis) == 1:
            return axis[0]
        raise ValueError(f"unknown mesh axes {axis!r}")
    if axis in ("data", "model"):
        return axis
    raise ValueError(f"unknown mesh axis {axis!r}")


# torch 2.13 names the tiled collectives ``*_single``; torch 2.11 has only
# the older names
def _all_gather(out, inp, group):
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out, inp, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, group=group)
