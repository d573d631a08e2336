"""Training session: one visit loop over a data/backend plane.

    plane.setup()
    for visit in plane.schedule():
        plane.step(visit)                 # the only state transition
        callbacks.on_sweep_end(view)      # observation, never perturbation
    callbacks.on_fit_end(final_view)

A *plane* binds a data source to an execution backend.  The port runs
every plane of the JAX package: on the in-process backend the in-memory
corpus (``_MemoryPlane``, dense storage; ``route``/``staleness`` may be
``"auto"``), the same over tiered storage (``_TieredPlane``) and the
on-disk shard stream (``_StreamPlane``, the out-of-core trainer); on the
SPMD backend (``backend="spmd"``) a ``(data, model)`` mesh of ranks, one
process each, over either source (``_SpmdPlane``, ``_StreamSpmdPlane``;
``torch.distributed``, ``ps/spmd_worker.py``); on the network backend
(``backend="net"``) a parameter-server process and a pool of worker
processes over either source (``_NetPlane``).

Random streams, as the JAX package draws them, so a job's counts equal its
bitwise:

  * memory: ``init_state`` draws the initial topics from ``PRNGKey(seed)``
    itself, then ``key, sub = split(key)`` once before the plane, and once
    more before every sweep;
  * SPMD over memory: ``randint(PRNGKey(seed), [W, npad])`` over the
    stacked workers, then the *same* key goes on: per sweep ``key, sub =
    split(key)`` and rank ``r`` takes ``split(sub, W)[r]``;
  * stream, SPMD over a stream, and net: every draw derives from the base
    seed through ``fold_in`` chains keyed by *schedule position*
    (``stream_init_key``, ``stream_sweep_key``; SPMD: rank ``r`` takes
    ``split(stream_sweep_key(...), W)[r]``), never by host iteration state
    -- which is what makes resume bitwise, and a visit's sweep the same
    whichever worker runs it.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import ps
from repro_torch import rng as jrng
from repro_torch.api.callbacks import (Callback, CheckpointCallback,
                                       EvalCallback, SweepView)
from repro_torch.api.job import NET, SPMD, JobValidationError, LDAJob
from repro_torch.core import lightlda as lda
from repro_torch.core import perplexity as ppl
from repro_torch.data import stream as stream_mod
from repro_torch.device import Device, resolve_device
from repro_torch.kernels import ops
from repro_torch.train import async_exec
from repro_torch.train import checkpoint as ckpt


class SessionResult(NamedTuple):
    """What a finished run hands back: the final PS handles, the eval
    callback's ``history`` rows, the executor's realised schedule
    (``info``), the final ``SamplerState`` of an in-memory run, and the
    stream reader of a streamed run (its z files hold the assignments)."""

    nwk: "ps.MatrixHandle"
    nk: "ps.VectorHandle"
    history: list
    info: dict
    state: Optional["lda.SamplerState"]
    reader: Optional["stream_mod.ShardedCorpusReader"]


def unported_planes(job: LDAJob) -> List[str]:
    """Why the port cannot run ``job`` yet, one line per plane it needs.
    Every plane of the JAX package is ported, so the list is empty."""
    return []


# ---------------------------------------------------------------------------
# Stream random streams: every draw derives from one base seed through
# ``fold_in`` chains keyed by schedule position.
# ---------------------------------------------------------------------------

def stream_init_key(seed: int, shard_id: int,
                    device: Device = "cpu") -> torch.Tensor:
    """Key for shard ``shard_id``'s initial topic assignment draw."""
    return ops.fold_in(jrng.PRNGKey(seed, device), 0, shard_id)


def stream_sweep_key(seed: int, epoch: int, pos: int,
                     device: Device = "cpu") -> torch.Tensor:
    """Key for the sweep at schedule position (epoch, pos)."""
    return ops.fold_in(jrng.PRNGKey(seed, device), 1, epoch, pos)


def init_stream(reader, cfg, seed: int = 0, client=None,
                device: Device = None):
    """Pass 0 of stream training: draw every shard's initial assignments
    on ``device`` (persisted as the shard's ``z`` file) and histogram the
    global count tables on the host.  One streaming pass; host memory is
    O(V x K) + one shard.

    Returns ``(nwk, nk)`` PS handles on ``device`` holding the initial
    counts."""
    dev = resolve_device(device)
    meta = reader.meta
    k = cfg.K
    nwk = np.zeros((meta.vocab_size, k), np.int32)
    nk = np.zeros(k, np.int64)
    for sid in range(meta.num_shards):
        shard = reader.shard(sid, load_z=False)
        z = ops.randint(stream_init_key(seed, sid, dev),
                        (meta.tokens_per_shard,), 0, k).cpu().numpy()
        z[shard.n_tokens:] = 0
        reader.write_z(sid, z)
        wv = np.asarray(shard.w[:shard.n_tokens])
        zv = z[:shard.n_tokens]
        np.add.at(nwk, (wv, zv), 1)
        nk += np.bincount(zv, minlength=k)
    client = client or ps.client_for(cfg)
    return (client.matrix_from_dense(torch.from_numpy(nwk).to(dev)),
            client.wrap_vector(torch.from_numpy(nk.astype(np.int32))
                               .to(dev)))


def seed_net_server(ctl, reader, cfg, seed: int, epochs: int, *,
                    mode: str = "dynamic", workers: int = 0,
                    max_shards: Optional[int] = None,
                    device: Device = None) -> list:
    """Pass 0 of a network-PS run against the server that ``ctl`` (a
    ``ps.net.NetClient``) is connected to: draw every shard's initial
    assignments on ``device`` (``init_stream``), add the initial counts to
    the server's tables and install the visit schedule as its lease plan
    (``mode``; the start gate holds until ``workers`` have registered).
    Returns the schedule, ``[(epoch, pos, shard)]``."""
    from repro_torch.ps.net import wire

    nwk0, nk0 = init_stream(reader, cfg, seed,
                            client=ps.PSClient.create(num_shards=1),
                            device=device)
    ctl.push_dense_prefix(wire.MAT_NWK, nwk0.to_dense().cpu().numpy())
    ctl.push_dense_prefix(wire.MAT_NK, nk0.value.cpu().numpy())
    del nwk0, nk0
    loader = stream_mod.StreamingLoader(reader, seed=seed, prefetch=False)
    sched = [(c.epoch, c.pos, s) for c, s in
             loader.schedule(stream_mod.Cursor(0, 0), epochs)]
    if max_shards is not None:
        sched = sched[:max_shards]
    ctl.plan(sched, mode=mode, slots=workers if mode != "dynamic" else 0,
             expected_workers=workers)
    return sched


# ---------------------------------------------------------------------------
# SPMD wiring: one rank's sweep, and the initial state of every worker.
# ---------------------------------------------------------------------------

def make_spmd_sweep(mesh, cfg: "lda.LDAConfig", staleness: int = 0,
                    hot_words=None, route: Optional["ps.PushRoute"] = None):
    """This rank's part of the SPMD sweep -- what ``shard_map`` runs on one
    mesh shard in the JAX package: tokens split over ``(data, model)``,
    ``n_wk`` rows cyclic over ``model`` (the servers), deltas summed over
    all workers.  The count tables enter through an SPMD-backed
    ``PSClient``, so the sweep takes its collectives (the all-gather pull,
    one sum per group) from the handle's backend.

    Returns ``sweep(w, d, z, valid, doc_start, doc_len, ndk, nwk_local,
    nk, key) -> (z, ndk, nwk_local, nk)``: this rank's slices of the
    stacked per-worker arrays, its ``[rows_per_shard, K]`` server shard,
    the replicated ``n_k`` and its own key (row ``rank`` of the sweep's
    key batch)."""
    client = ps.client_for(cfg, mesh=mesh, axis_name=("data", "model"),
                           model_axis="model")

    def local(w, d, z, valid, doc_start, doc_len, ndk, nwk_local, nk, key):
        state = lda.SamplerState(w, d, z, valid, doc_start, doc_len,
                                 client.wrap_matrix(nwk_local, cfg.V),
                                 client.wrap_vector(nk), ndk)
        out = lda.sweep(state, key, cfg, staleness=staleness,
                        hot_words=hot_words, route=route)
        return out.z, out.ndk, out.nwk.value, out.nk.value

    return local


def init_distributed_state(corp, cfg: "lda.LDAConfig", workers: int,
                           key: torch.Tensor, device: Device = None):
    """Shard the corpus over ``workers`` and build the global count tables
    on ``device``, as the JAX package does.

    Returns ``(w, d, valid, doc_start, doc_len, z, ndk, nwk, nk)`` with a
    leading worker dim on the per-worker arrays; ``z`` is ``randint(key,
    [workers, npad], 0, K)``; ``nwk`` is an in-process handle, cyclic over
    ``cfg.num_shards``."""
    from repro_torch.data import corpus as corpus_mod

    dev = resolve_device(device)
    shards = corpus_mod.shard_tokens(corp, workers, cfg.block_tokens)
    npad = max(sh[0].shape[0] for sh in shards)
    dmax = max(sh[3].shape[0] for sh in shards)

    def stack(i, pad_to):
        return torch.from_numpy(np.stack([
            np.pad(sh[i], (0, pad_to - len(sh[i])), constant_values=0)
            for sh in shards])).to(dev)

    w, d, valid = stack(0, npad), stack(1, npad), stack(2, npad)
    doc_start, doc_len = stack(3, dmax), stack(4, dmax)
    z = ops.randint(key.to(dev), (workers, npad), 0, cfg.K)
    # counts from the valid tokens of the global view
    m = valid.reshape(-1)
    wv, zv = w.reshape(-1)[m].long(), z.reshape(-1)[m].long()
    ones = torch.ones(wv.shape[0], dtype=torch.int32, device=dev)
    nwk = torch.zeros(cfg.V * cfg.K, dtype=torch.int32, device=dev
                      ).index_add_(0, wv * cfg.K + zv, ones
                                   ).view(cfg.V, cfg.K)
    nk = torch.zeros(cfg.K, dtype=torch.int32, device=dev).index_add_(
        0, zv, ones)
    widx = torch.arange(workers, device=dev)[:, None].expand(-1, npad)
    ndk = torch.zeros(workers * dmax * cfg.K, dtype=torch.int32,
                      device=dev).index_add_(
        0, (widx.reshape(-1)[m] * dmax + d.reshape(-1)[m].long()) * cfg.K
        + zv, ones).view(workers, dmax, cfg.K)
    return (w, d, valid, doc_start, doc_len, z, ndk,
            ps.client_for(cfg).matrix_from_dense(nwk), nk)


# ---------------------------------------------------------------------------
# The generic visit loop.
# ---------------------------------------------------------------------------

def _run_loop(plane, callbacks: Sequence[Callback]) -> SessionResult:
    # Spans cover the host side of each visit -- the executor step
    # (``session.step``) and the observers (``session.callbacks``); with no
    # obs session each is the no-op NULL_SPAN.
    # A plane that owns processes or sockets (the net plane) has a
    # ``close``, called however the run ends.
    try:
        with _obs.span("session.setup", cat="session", kind=plane.kind):
            plane.setup()
        info = dict(plane.info)
        for cb in callbacks:
            cb.on_fit_start(info)
        view = None
        stopped = False
        for visit in plane.schedule():
            with _obs.span("session.step", cat="session"):
                plane.step(visit)
            view = plane.view(visit)
            with _obs.span("session.callbacks", cat="session",
                           n=len(callbacks)):
                for cb in callbacks:
                    cb.on_sweep_end(view)
            if plane.should_stop():
                stopped = True
                break
        final = plane.final_view(view)
        for cb in callbacks:
            cb.on_fit_end(final)
        plane.finish(stopped)
    finally:
        close = getattr(plane, "close", None)
        if close is not None:
            close()
    return plane.result()


# ---------------------------------------------------------------------------
# The plane: in-memory corpus, in-process backend, dense storage.
# ---------------------------------------------------------------------------

class _MemoryPlane:
    """Resident ``SamplerState`` driven through ``make_executor``;
    ``key, sub = split(key)`` before every sweep."""

    kind = "memory"

    def __init__(self, cfg, exec_cfg, state, key, sweeps, log_fn=print):
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.state = state
        self.key = key
        self.sweeps = int(sweeps)
        self.log_fn = log_fn
        self.info: dict = {}
        self.t0 = time.time()
        self._ready = False

    def setup(self):
        if self._ready:
            return
        self._ready = True
        cfg, state = self.cfg, self.state
        self.step_fn, info = async_exec.make_executor(state, cfg,
                                                      self.exec_cfg)
        self.info = dict(info)
        tuned = info.get("autotune")
        if tuned is not None:
            self.log_fn(f"[lda] autotune: chose {tuned['chosen']} "
                        f"(route='auto'/staleness='auto' measured against "
                        f"the materialised state)")
        if info["mode"] == "blocked":
            rpb = info["rows_per_block"]
            self.log_fn(
                f"[lda] blocked executor: {info['n_blocks']} model blocks "
                f"x {rpb} rows, group {info['group']} (staleness "
                f"{info['staleness']}), route {info['route']}, "
                f"worker block mem "
                f"{info['group'] * rpb * cfg.K * 4 / 2**20:.1f} MiB (vs "
                f"{state.nwk.layout.pad_rows * cfg.K * 4 / 2**20:.1f} MiB "
                f"snapshot)")
        else:
            self.log_fn(
                f"[lda] snapshot executor: {info['n_blocks']} token "
                f"blocks, group {info['group']} (staleness "
                f"{info['staleness']}), route {info['route']}")
        self.num_tokens = int(state.valid.sum())
        self.t0 = time.time()

    def schedule(self):
        return range(self.sweeps)

    def step(self, i: int):
        self.key, sub = ops.split(self.key)
        self.state = self.step_fn(self.state, sub)

    def view(self, i: int) -> SweepView:
        st = self.state
        return SweepView(self, step=i + 1, epoch=0, pos=i, shard_id=None,
                         is_last=(i == self.sweeps - 1), state=st,
                         nwk=st.nwk, nk=st.nk,
                         tokens_seen=self.num_tokens * (i + 1))

    # -- observation hooks ------------------------------------------------
    def sync(self, view):
        if view.state.z.is_cuda:
            torch.cuda.synchronize(view.state.z.device)

    def perplexity(self, view) -> float:
        st, cfg = view.state, self.cfg
        return float(ppl.training_perplexity(
            st.w, st.d, st.valid, st.ndk, st.nwk.to_dense(), st.nk.value,
            cfg.alpha, cfg.beta))

    def history_row(self, view, p: float) -> dict:
        el = view.elapsed_s
        return {"sweep": view.step, "perplexity": p, "elapsed_s": el,
                "tokens_per_s": self.num_tokens * view.step / el}

    def log_line(self, view, p: float) -> str:
        el = view.elapsed_s
        return (f"[lda] sweep {view.step:4d}  perplexity {p:9.2f}  "
                f"({el:.1f}s, {self.num_tokens * view.step / el:,.0f} "
                f"tok/s)")

    def checkpoint(self, view, path: str):
        ckpt.save_lda(path, view.state if view.state is not None
                      else self.state)

    # -- loop plumbing ----------------------------------------------------
    def should_stop(self) -> bool:
        return False

    def final_view(self, last: Optional[SweepView]) -> Optional[SweepView]:
        if last is not None:
            return last
        st = self.state
        return SweepView(self, step=0, epoch=0, pos=0, shard_id=None,
                         is_last=True, state=st, nwk=st.nwk, nk=st.nk,
                         tokens_seen=0)

    def finish(self, stopped: bool):
        pass

    def result(self) -> SessionResult:
        st = self.state
        return SessionResult(st.nwk, st.nk, [], self.info, st, None)


def memory_fit(state, key, cfg, exec_cfg, sweeps, *, eval_every=10,
               log_fn=print, callbacks: Sequence[Callback] = ()):
    """Train a resident state for ``sweeps`` sweeps on the memory plane;
    returns ``(state, history, info)``."""
    plane = _MemoryPlane(cfg, exec_cfg, state, key, sweeps, log_fn)
    ev = EvalCallback(every=eval_every, include_last=True, log_fn=log_fn)
    _run_loop(plane, [ev, *callbacks])
    return plane.state, ev.history, plane.info


# ---------------------------------------------------------------------------
# The tiered plane: in-memory corpus over tiered parameter storage.
# ---------------------------------------------------------------------------

class _TieredPlane(_MemoryPlane):
    """The memory plane with the count table in tiered storage: the
    ``hot_rows`` hottest rows on the device, the full ``[V, K]`` table in
    a host memmap cold store (``repro_torch.ps.tiered``).

    Differences from ``_MemoryPlane``, all confined to setup/teardown: the
    initial ``n_wk`` is histogrammed on the *host* straight into the cold
    store (the full table never lands on the device -- the point of the
    plane), ``n_k`` and ``n_dk`` from the valid tokens alone, the executor
    is ``make_tiered_executor``'s host-driven blocked loop, and ``finish``
    flushes the cold store and reports the tier's hit rate.  The visit
    protocol, eval and RNG discipline are inherited: the initial topics are
    ``randint`` from ``PRNGKey(seed)`` itself, then the sweep key chain
    ``key, sub = split(key)``, as the JAX package draws them.
    """

    kind = "tiered"

    def __init__(self, corp, cfg, exec_cfg, sweeps, job, log_fn=print,
                 device: Device = None):
        super().__init__(cfg, exec_cfg, None, None, sweeps, log_fn)
        self.corp = corp
        self.job = job
        self.device = resolve_device(device)
        self.tier_dir: Optional[str] = None

    def setup(self):
        if self._ready:
            return
        self._ready = True
        import tempfile

        from repro_torch.ps import autotune as _autotune
        from repro_torch.ps import tiered as tiered_mod

        cfg, corp, job, dev = self.cfg, self.corp, self.job, self.device
        key = jrng.PRNGKey(job.seed, dev)

        # token arrays + z init, padded exactly like lda.init_state
        n = int(corp.w.shape[0])
        pad = (-n) % cfg.block_tokens
        w_np = np.asarray(corp.w, np.int32)
        z = ops.randint(key, (n,), 0, cfg.K)
        z_np = z.cpu().numpy()

        def padded(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.concatenate(
                [np.asarray(x, np.int32), np.zeros(pad, np.int32)])).to(dev)

        w, d = padded(w_np), padded(corp.d)
        z = padded(z_np)
        valid = torch.arange(n + pad, device=dev) < n
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        doc_len = torch.zeros(corp.num_docs, dtype=torch.int32,
                              device=dev).index_add_(0, d[:n].long(), ones)
        doc_start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                               torch.cumsum(doc_len, 0)[:-1].to(torch.int32)])

        # counts: n_wk histogrammed on the host straight into the cold
        # store; n_k and n_dk from the valid tokens on the device
        nwk_np = np.zeros((cfg.V, cfg.K), np.int32)
        np.add.at(nwk_np, (w_np, z_np), 1)
        nk = torch.zeros(cfg.K, dtype=torch.int32, device=dev).index_add_(
            0, z[:n].long(), ones)
        ndk = torch.zeros(corp.num_docs * cfg.K, dtype=torch.int32,
                          device=dev).index_add_(
            0, d[:n].long() * cfg.K + z[:n].long(), ones
        ).view(corp.num_docs, cfg.K)

        hot_rows = job.hot_rows
        if hot_rows is None:
            freq = _autotune.word_frequencies(w_np, None, cfg.V)
            hot_rows = _autotune.size_hot_rows(freq, cfg.K)
        self.tier_dir = job.tier_dir or tempfile.mkdtemp(
            prefix="repro-tier-")
        client = ps.PSClient(backend=tiered_mod.TieredBackend())
        nwk = tiered_mod.tiered_matrix_from_dense(
            nwk_np, hot_rows, self.tier_dir,
            route=self.exec_cfg.resolve_route(cfg.V), client=client,
            device=dev)
        del nwk_np
        self.state = lda.SamplerState(w, d, z, valid, doc_start, doc_len,
                                      nwk, client.wrap_vector(nk), ndk)
        _, self.key = ops.split(key)

        self.step_fn, info = async_exec.make_tiered_executor(
            self.state, cfg, self.exec_cfg,
            refresh_every=job.tier_refresh,
            auto_resize=(job.hot_rows is None))
        self.info = dict(info, storage="tiered", tier_dir=self.tier_dir)
        tier = nwk.tier
        self.log_fn(
            f"[lda] tiered storage: hot {tier.hot_rows} / {cfg.V} rows "
            f"({tier.device_bytes() / 2**20:.2f} MiB device) over cold "
            f"memmap {tier.cold.nbytes / 2**20:.1f} MiB at "
            f"{self.tier_dir}; {info['n_blocks']} blocks x "
            f"{info['rows_per_block']} rows, route {info['route']}")
        self.num_tokens = n
        self.t0 = time.time()

    def checkpoint(self, view, path: str):
        raise ValueError("checkpointing tiered storage is not supported "
                         "yet; the cold store under tier_dir persists the "
                         "count table itself (and TopicModel.save the "
                         "frozen model)")

    def finish(self, stopped: bool):
        st = self.state
        st.nwk.flush()
        s = st.nwk.tier_stats()
        self.log_fn(
            f"[lda] tier: hit rate {s.hit_rate():.3f} "
            f"({s.hits}/{s.hits + s.misses} changed assignments "
            f"device-local), {s.promotions} promotions, {s.evictions} "
            f"evictions, H2D {s.h2d_bytes / 2**20:.1f} MiB, D2H "
            f"{s.d2h_bytes / 2**20:.1f} MiB")


# ---------------------------------------------------------------------------
# The stream plane: on-disk shard stream, in-process backend.
# ---------------------------------------------------------------------------

class _StreamPlane:
    """Multi-epoch out-of-core training over a sharded stream.

    The model (the PS count tables, on ``device``) is the only global
    state; token data streams through shard by shard via the
    double-buffered ``StreamingLoader``.  Each shard visit moves the shard
    to the device, rebuilds its worker-local ``n_dk`` from the persisted
    assignments, runs one executor sweep against the *global* handles, and
    writes the updated ``z`` back -- the paper's section-3.5 discipline
    (assignments are data; counts are derived).  All randomness derives
    from (seed, schedule position), so resume is bitwise.

    With an obs session installed, each visit's host-side parts are spans
    closed by a device synchronise: ``stream.index`` (blocked mode: the
    host token index, on the loader's prefetch thread unless
    ``prefetch=False``), ``stream.h2d``, ``stream.ndk``, the executor's
    ``exec.sweep``, and ``stream.write_z`` (device -> host -> disk); the
    loader adds ``stream.shard_wait`` and the prefetch hit/miss counters.
    """

    kind = "stream"

    def __init__(self, reader, cfg, exec_cfg, epochs, *, seed=0,
                 checkpoint_path=None, resume=False, max_shards=None,
                 prefetch=True, log_fn=print, device: Device = None):
        if isinstance(reader, str):
            reader = stream_mod.ShardedCorpusReader(reader)
        self.reader = reader
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.checkpoint_path = checkpoint_path
        self.resume = resume
        self.max_shards = max_shards
        self.prefetch = prefetch
        self.log_fn = log_fn
        self.device = resolve_device(device)
        self.info: dict = {}
        self.t0 = time.time()
        self._ready = False

    def setup(self):
        if self._ready:
            return
        self._ready = True
        cfg, reader, dev = self.cfg, self.reader, self.device
        meta = reader.meta
        if (self.exec_cfg.model_blocks == 0
                and meta.tokens_per_shard % cfg.block_tokens):
            raise ValueError(
                f"tokens_per_shard={meta.tokens_per_shard} must be a "
                f"multiple of block_tokens={cfg.block_tokens} for the "
                f"snapshot executor")
        self.ckpt_meta = {"vocab_size": cfg.V, "num_topics": cfg.K,
                          "ps_shards": cfg.num_shards,
                          "tokens_per_shard": meta.tokens_per_shard,
                          "stream_shards": meta.num_shards}
        client = ps.client_for(cfg)
        if self.resume:
            path = self.checkpoint_path
            if not (path and os.path.exists(path)):
                raise FileNotFoundError(
                    f"resume requested but no checkpoint at {path}")
            saved = ckpt.restore_stream(path)
            mismatch = {k: (saved.meta.get(k), v)
                        for k, v in self.ckpt_meta.items()
                        if saved.meta.get(k) != v}
            if mismatch:
                raise ValueError(f"checkpoint/config mismatch: {mismatch}")
            self.seed = saved.seed
            self.nwk = client.wrap_matrix(
                torch.from_numpy(saved.nwk_phys).to(dev), cfg.V)
            self.nk = client.wrap_vector(torch.from_numpy(saved.nk).to(dev))
            cursor = saved.cursor
            self.log_fn(f"[stream] resumed at epoch {cursor.epoch} pos "
                        f"{cursor.pos} (seed {self.seed}) from {path}")
        else:
            self.nwk, self.nk = init_stream(reader, cfg, self.seed,
                                            client=client, device=dev)
            cursor = stream_mod.Cursor(0, 0)
        self.cursor0 = cursor
        self.final_cursor = cursor

        self.step_fn, self.build_index, info = \
            async_exec.make_stream_executor(cfg, self.exec_cfg,
                                            self.nwk.layout)
        self.info = dict(info, stream_shards=meta.num_shards,
                         tokens_per_shard=meta.tokens_per_shard,
                         num_tokens=meta.num_tokens)
        self.valid_np = np.arange(meta.tokens_per_shard)
        # blocked mode: the loader's prefetch thread builds each shard's
        # token index beside its load (without prefetch, step builds it)
        prepare = (self._index if self.build_index is not None
                   and self.prefetch else None)
        self.loader = stream_mod.StreamingLoader(reader, seed=self.seed,
                                                 prefetch=self.prefetch,
                                                 prepare=prepare)
        self.total_visits = len(self.loader.schedule(cursor, self.epochs))
        if self.max_shards is not None:
            self.total_visits = min(self.total_visits, self.max_shards)
        self.valid_dev = torch.arange(meta.tokens_per_shard, device=dev)
        self.shards_done = 0
        self.tokens_seen = 0
        self.state: Optional[lda.SamplerState] = None
        self.t0 = time.time()

    def schedule(self):
        return self.loader.iterate(self.cursor0, self.epochs)

    def _index(self, shard) -> tuple:
        """Blocked mode's host token index of one shard: ``(idx, bval,
        valid slots per block)``."""
        with _obs.span("stream.index", cat="stream", shard=shard.shard_id):
            idx, bval = self.build_index(
                shard.w, self.valid_np < shard.n_tokens)
            return idx, bval, bval.sum(1).tolist()

    def step(self, visit):
        cur, sid, shard = visit[:3]
        cfg, meta, dev = self.cfg, self.reader.meta, self.device
        if shard.z is None:
            raise FileNotFoundError(
                f"shard {sid} has no z file; stream was never initialised")
        n = shard.n_tokens
        index, counts = (), ()
        if self.build_index is not None:
            # built on the loader thread (a Future: its error raises here)
            idx, bval, cnt = (visit[3].result() if len(visit) > 3
                              else self._index(shard))
            index, counts = (idx, bval), (cnt,)
        with _obs.span("stream.h2d", cat="stream", shard=sid) as sp:
            w, d, z, doc_start, doc_len = (
                torch.from_numpy(x).to(dev)
                for x in (shard.w, shard.d, shard.z, shard.doc_start,
                          shard.doc_len))
            index = [x.to(dev) for x in index]
            sp.sync_on(z)
        valid = self.valid_dev < n
        with _obs.span("stream.ndk", cat="stream", shard=sid) as sp:
            # the valid tokens are the first n: histogram those alone (an
            # accumulating put over the padding would add every padded slot
            # into one address, one after another)
            ndk = torch.zeros(meta.doc_cap * cfg.K, dtype=torch.int32,
                              device=dev).index_add_(
                0, d[:n].long() * cfg.K + z[:n].long(),
                torch.ones(n, dtype=torch.int32, device=dev)
            ).view(meta.doc_cap, cfg.K)
            sp.sync_on(ndk)
        state = lda.SamplerState(w, d, z, valid, doc_start, doc_len,
                                 self.nwk, self.nk, ndk)
        key = stream_sweep_key(self.seed, cur.epoch, cur.pos, dev)
        state = self.step_fn(state, key, *index, *counts)
        with _obs.span("stream.write_z", cat="stream", shard=sid):
            self.reader.write_z(sid, state.z.cpu().numpy())
        self.state = state
        self.nwk, self.nk = state.nwk, state.nk
        self.shards_done += 1
        self.tokens_seen += n
        self.final_cursor = cur.next(meta.num_shards)

    def view(self, visit) -> SweepView:
        cur, sid = visit[:2]
        return SweepView(self, step=self.shards_done, epoch=cur.epoch,
                         pos=cur.pos, shard_id=sid,
                         is_last=(self.shards_done >= self.total_visits),
                         state=self.state, nwk=self.nwk, nk=self.nk,
                         tokens_seen=self.tokens_seen,
                         cursor_next=self.final_cursor)

    # -- observation hooks ------------------------------------------------
    def sync(self, view):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def perplexity(self, view) -> float:
        st, cfg = view.state, self.cfg
        return float(ppl.training_perplexity(
            st.w, st.d, st.valid, st.ndk, st.nwk.to_dense(), st.nk.value,
            cfg.alpha, cfg.beta))

    def history_row(self, view, p: float) -> dict:
        el = view.elapsed_s
        return {"epoch": view.epoch, "pos": view.pos,
                "shard": view.shard_id, "perplexity": p, "elapsed_s": el,
                "tokens_per_s": self.tokens_seen / el}

    def log_line(self, view, p: float) -> str:
        el = view.elapsed_s
        return (f"[stream] epoch {view.epoch} shard {view.pos:3d} "
                f"(#{view.shard_id})  perplexity {p:9.2f}  "
                f"({self.tokens_seen / el:,.0f} tok/s)")

    def checkpoint(self, view, path: str):
        # the physical (cyclic) layout, as the JAX package saves it
        with _obs.span("stream.save", cat="stream"):
            ckpt.save_stream(path, self.nwk.value, self.nk.value,
                             view.cursor_next, self.seed, self.ckpt_meta)

    # -- loop plumbing ----------------------------------------------------
    def should_stop(self) -> bool:
        return (self.max_shards is not None
                and self.shards_done >= self.max_shards)

    def final_view(self, last: Optional[SweepView]) -> Optional[SweepView]:
        if last is not None:
            return last
        return SweepView(self, step=0, epoch=self.cursor0.epoch,
                         pos=self.cursor0.pos, shard_id=None, is_last=True,
                         state=None, nwk=self.nwk, nk=self.nk,
                         tokens_seen=0, cursor_next=self.final_cursor)

    def finish(self, stopped: bool):
        if stopped:
            self.log_fn(f"[stream] stopping after {self.shards_done} "
                        f"shards (max_shards), cursor -> epoch "
                        f"{self.final_cursor.epoch} pos "
                        f"{self.final_cursor.pos}")
        elif self.shards_done:
            el = time.time() - self.t0
            self.log_fn(f"[stream] done: {self.shards_done} shard visits, "
                        f"{self.tokens_seen} tokens in {el:.1f}s "
                        f"({self.tokens_seen / el:,.0f} tok/s)")

    def result(self) -> SessionResult:
        return SessionResult(self.nwk, self.nk, [], self.info, None,
                             self.reader)


def stream_fit(reader, cfg, exec_cfg, epochs, *, seed=0,
               checkpoint_path=None, checkpoint_every=0, resume=False,
               max_shards=None, eval_every=0, prefetch=True, log_fn=print,
               callbacks: Sequence[Callback] = (), device: Device = None):
    """Train over a shard stream on ``device`` (the card unless the caller
    passes another) for ``epochs`` epochs; returns ``(nwk, nk, history,
    info)``."""
    plane = _StreamPlane(reader, cfg, exec_cfg, epochs, seed=seed,
                         checkpoint_path=checkpoint_path, resume=resume,
                         max_shards=max_shards, prefetch=prefetch,
                         log_fn=log_fn, device=device)
    ev = EvalCallback(every=eval_every, include_last=False, log_fn=log_fn)
    cbs: List[Callback] = [ev, *callbacks]
    if checkpoint_path:
        cbs.append(CheckpointCallback(checkpoint_path,
                                      every=checkpoint_every))
    _run_loop(plane, cbs)
    return plane.nwk, plane.nk, ev.history, plane.info


# ---------------------------------------------------------------------------
# The net plane: stream (or materialised memory) source, network backend --
# a standalone PS process + an elastic pool of worker subprocesses
# (repro_torch.ps.net, DESIGN.md section 15).
# ---------------------------------------------------------------------------

class _NetPlane:
    """Training through the network parameter server.

    The session process never samples: it seeds the stream
    (``init_stream``), loads the initial counts into the server (embedded
    here, or ``job.server``), installs the visit schedule as a lease plan,
    spawns the worker pool (each worker sweeps on ``device``) and then
    *supervises* -- each ``step`` waits for one more lease to commit,
    reaping dead workers (their leases re-queue) along the way.  The
    conservation law (server counts == histogram of the on-disk z) holds
    at every commit boundary; a 1-worker run is bitwise identical to
    ``_StreamPlane`` (same ``stream_sweep_key``, same executor).  ``close``
    kills the pool and stops an embedded server, whether the run finished
    or raised.
    """

    kind = "net"

    def __init__(self, source, cfg, exec_cfg, epochs, job, *, log_fn=print,
                 device: Device = None):
        # source: a ShardedCorpusReader (stream job) or a Corpus (memory
        # job -- materialised into a temporary stream dir in setup)
        self.source = source
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.epochs = int(epochs)
        self.job = job
        self.seed = int(job.seed)
        self.log_fn = log_fn
        self.device = resolve_device(device)
        self.info: dict = {}
        self.t0 = time.time()
        self.visit_timeout = 600.0
        self._ready = False
        self._server = None
        self._final = None
        self.pool = None
        self.ctl = None

    # -- lifecycle ---------------------------------------------------------
    def setup(self):
        if self._ready:
            return
        self._ready = True
        import tempfile

        from repro_torch.ps.net import (NetClient, PSServer, WorkerConfig,
                                        WorkerPool, wire)
        self._wire = wire
        job, cfg = self.job, self.cfg
        if isinstance(self.source, stream_mod.ShardedCorpusReader):
            self.reader = self.source
            self.stream_dir = job.stream_dir
        else:
            # materialise the in-memory corpus as a stream the worker
            # processes can read; shard size targets ~2 visits per worker
            # per epoch, rounded to the executor's block granularity
            self.stream_dir = tempfile.mkdtemp(prefix="repro-net-")
            corp = self.source
            target = max(2 * job.workers, 4)
            blocks = max(1, -(-corp.w.shape[0] //
                              (cfg.block_tokens * target)))
            stream_mod.write_sharded(self.stream_dir, corp,
                                     tokens_per_shard=blocks
                                     * cfg.block_tokens)
            self.reader = stream_mod.ShardedCorpusReader(self.stream_dir)
        meta = self.reader.meta
        if (self.exec_cfg.model_blocks == 0
                and meta.tokens_per_shard % cfg.block_tokens):
            raise ValueError(
                f"tokens_per_shard={meta.tokens_per_shard} must be a "
                f"multiple of block_tokens={cfg.block_tokens} for the "
                f"snapshot executor")

        self._client = ps.PSClient.create(num_shards=1)
        if job.server:
            self.address = job.server
        else:
            self._server = PSServer(cfg.V, cfg.K,
                                    stream_dir=self.stream_dir,
                                    log_fn=self.log_fn).start()
            self.address = self._server.address
        self.ctl = NetClient.connect(self.address, name="session-ctl",
                                     role="ctl")
        if (self.ctl.meta["vocab"] != cfg.V
                or self.ctl.meta["topics"] != cfg.K):
            raise ValueError(
                f"server at {self.address} hosts a "
                f"[{self.ctl.meta['vocab']}, {self.ctl.meta['topics']}] "
                f"table; this job needs [{cfg.V}, {cfg.K}]")
        mode = job.net_assign
        self.sched = seed_net_server(self.ctl, self.reader, cfg, self.seed,
                                     self.epochs, mode=mode,
                                     workers=job.workers,
                                     max_shards=job.max_shards,
                                     device=self.device)
        self.total_visits = len(self.sched)

        base = WorkerConfig(
            server=self.address, stream_dir=self.stream_dir,
            num_topics=cfg.K, alpha=cfg.alpha, beta=cfg.beta,
            mh_steps=cfg.mh_steps, block_tokens=cfg.block_tokens,
            model_blocks=self.exec_cfg.model_blocks,
            staleness=int(self.exec_cfg.staleness),
            hot_words=self.exec_cfg.hot_words, seed=self.seed,
            commit_hot_rows=self.exec_cfg.hot_words or 0,
            device=str(self.device))
        self.pool = WorkerPool(self.address, base, log_fn=self.log_fn)
        self.pool.start(job.workers)
        self._shard_tokens = [self.reader.shard(s, load_z=False).n_tokens
                              for s in range(meta.num_shards)]
        self.info = {"mode": "net", "workers": job.workers,
                     "net_assign": mode, "server": self.address,
                     "stream_shards": meta.num_shards,
                     "tokens_per_shard": meta.tokens_per_shard,
                     "num_tokens": meta.num_tokens,
                     "total_visits": self.total_visits,
                     "worker_logs": self.pool.log_dir}
        self.shards_done = 0
        self.tokens_seen = 0
        self.t0 = time.time()

    def schedule(self):
        return range(self.total_visits)

    def step(self, i: int):
        """Wait for the (i+1)-th lease commit, supervising the pool."""
        deadline = time.time() + self.visit_timeout
        while True:
            self.pool.reap()
            st = self.ctl.status()
            leases = st.get("leases") or {}
            if leases.get("done", 0) > i:
                break
            if self.pool.alive() == 0:
                raise RuntimeError(
                    f"all workers exited with "
                    f"{self.total_visits - leases.get('done', 0)} visits "
                    f"unfinished: {leases}; logs in {self.pool.log_dir}")
            if time.time() > deadline:
                raise TimeoutError(
                    f"no lease commit within {self.visit_timeout}s "
                    f"(done={leases.get('done', 0)}/{self.total_visits})")
            time.sleep(0.05)
        self.shards_done = i + 1
        self.tokens_seen += self._shard_tokens[self.sched[i][2]]

    def view(self, i: int) -> SweepView:
        e, p, s = self.sched[i]
        return SweepView(self, step=self.shards_done, epoch=e, pos=p,
                         shard_id=s,
                         is_last=(self.shards_done >= self.total_visits),
                         state=None, nwk=None, nk=None,
                         tokens_seen=self.tokens_seen,
                         cursor_next=stream_mod.Cursor(e, p).next(
                             self.reader.meta.num_shards))

    # -- observation hooks -------------------------------------------------
    def sync(self, view):
        pass

    def perplexity(self, view) -> float:
        """Live stream-wide eval: current server counts + persisted z.
        Mid-training this reads *moving* state (atomic per shard); the
        final call sees the quiesced model."""
        nwk = self.ctl.pull_full(self._wire.MAT_NWK)
        nk = self.ctl.pull_full(self._wire.MAT_NK)
        return ppl.stream_training_perplexity(self.reader, nwk, nk,
                                              self.cfg.alpha, self.cfg.beta,
                                              device=self.device)

    def history_row(self, view, p: float) -> dict:
        el = view.elapsed_s
        return {"epoch": view.epoch, "pos": view.pos,
                "shard": view.shard_id, "perplexity": p, "elapsed_s": el,
                "tokens_per_s": self.tokens_seen / el}

    def log_line(self, view, p: float) -> str:
        el = view.elapsed_s
        return (f"[net] visit {view.step}/{self.total_visits} "
                f"(epoch {view.epoch})  perplexity {p:9.2f}  "
                f"({self.tokens_seen / el:,.0f} tok/s)")

    def checkpoint(self, view, path: str):
        raise NotImplementedError(
            "checkpointing the net plane is not supported (LDAJob "
            "validation rejects it)")

    # -- loop plumbing -----------------------------------------------------
    def should_stop(self) -> bool:
        return False

    def final_view(self, last: Optional[SweepView]) -> Optional[SweepView]:
        if last is not None:
            return last
        return SweepView(self, step=0, epoch=0, pos=0, shard_id=None,
                         is_last=True, state=None, nwk=None, nk=None,
                         tokens_seen=0,
                         cursor_next=stream_mod.Cursor(0, 0))

    def finish(self, stopped: bool):
        status = self.pool.join(timeout=self.visit_timeout)
        self._final = (self.ctl.pull_full(self._wire.MAT_NWK),
                       self.ctl.pull_full(self._wire.MAT_NK))
        self.info["server_status"] = status
        self.info["worker_stats"] = self.pool.stats()
        el = time.time() - self.t0
        if self.shards_done:
            self.log_fn(f"[net] done: {self.shards_done} shard visits over "
                        f"{self.job.workers} workers in {el:.1f}s "
                        f"({self.tokens_seen / el:,.0f} tok/s)")

    def close(self):
        """Kill the pool, stop an embedded server, drop the control
        client (idempotent; the loop calls it however the run ended)."""
        if self.pool is not None:
            self.pool.close()
        if self._server is not None:
            self._server.stop()      # embedded server dies with the run
            self._server = None
        if self.ctl is not None:
            self.ctl.close()
            self.ctl = None

    def result(self) -> SessionResult:
        nwk_np, nk_np = self._final
        dev = self.device
        nwk = self._client.matrix_from_dense(torch.from_numpy(nwk_np).to(dev))
        nk = self._client.wrap_vector(torch.from_numpy(nk_np).to(dev))
        return SessionResult(nwk, nk, [], self.info, None, self.reader)


# ---------------------------------------------------------------------------
# SPMD planes: rank 0 of a mesh of rank processes (ps/spmd_worker.py).
# ---------------------------------------------------------------------------

def default_devices(device: torch.device) -> int:
    """The rank count of an SPMD job that names none: every card on the
    card (``torch.cuda.device_count()``), one on the CPU -- as the JAX
    package's device count without forced host devices."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _resolve_mesh(cfg: "lda.LDAConfig", mesh_model: int, devices: int):
    """``(data, model, workers, cfg)`` for ``devices`` ranks and
    ``mesh_model`` servers, the PS shard count pinned to the model axis
    (paper section 2.2); the divisibility error of
    ``launch.mesh.resolve_mesh`` otherwise."""
    from repro_torch.launch.mesh import resolve_mesh

    data, model = resolve_mesh(devices, mesh_model)
    cfg = dataclasses.replace(cfg, num_shards=model)
    return data, model, data * model, cfg


class _MeshMatrix:
    """A view's ``n_wk`` on an SPMD run: gathered from the servers only
    when a callback reads it (one gather step of the command loop), then
    an in-process ``MatrixHandle`` over the full physical table.  A view
    reads the counts of its own visit; once the run has moved on, reading
    it raises."""

    def __init__(self, plane, step: int):
        self._plane = plane
        self._step = step
        self._handle = None

    def _get(self):
        if self._handle is None:
            if self._plane.steps_done != self._step:
                raise RuntimeError(
                    f"this view's counts (visit {self._step}) are gone: the "
                    f"SPMD run is at visit {self._plane.steps_done}")
            self._handle = self._plane.gathered_nwk()
        return self._handle

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._get(), name)


class _SpmdPlaneBase:
    """What the two SPMD planes share: the mesh, the rank processes, views
    whose counts are gathered on demand, and the result on rank 0.  The
    transport follows from the layout (``launch.mesh.transport_for``);
    ``transport`` pins one, for a caller that compares two on one layout
    (``Session`` never does)."""

    def _start(self, spec: dict, init=None) -> None:
        from repro_torch.ps.spmd_worker import SpmdRun

        # if start raises, the loop's ``close`` stops what it started
        self.run = SpmdRun(spec, self.device, log_fn=self.log_fn,
                           timeout_s=self.timeout_s,
                           transport=self.transport)
        self.run.start(init)
        self.steps_done = 0
        self._client = ps.client_for(self.cfg)
        self.info.update(collective=self.run.transport, devices=self.workers,
                         rank_logs=self.run.log_dir,
                         helper_pids=self.run.helper_pids)

    def gathered_nwk(self) -> "ps.MatrixHandle":
        """The full physical ``n_wk`` on rank 0 (a gather step)."""
        from repro_torch.ps.spmd_worker import OP_GATHER
        return self._client.wrap_matrix(self.run.do(OP_GATHER), self.cfg.V)

    def _view_handles(self, step: int):
        return (_MeshMatrix(self, step),
                self._client.wrap_vector(self.run.program.nk))

    def sync(self, view):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def perplexity(self, view) -> float:
        from repro_torch.ps.spmd_worker import OP_PPL
        return self.run.do(OP_PPL)

    def should_stop(self) -> bool:
        return False

    def final_view(self, last):
        return last

    def _finish_run(self) -> None:
        from repro_torch.ps.spmd_worker import OP_FINISH, OP_RESULT, OP_STATS

        self.info["ranks"] = self.run.do(OP_STATS)
        self._final = self.run.do(OP_RESULT)
        self.run.do(OP_FINISH)

    def close(self):
        """Stop every rank process and leave the process group
        (idempotent; the loop calls it however the run ended)."""
        run = getattr(self, "run", None)
        if run is not None:
            run.close()

    def _result_handles(self):
        f = self._final
        return (self._client.wrap_matrix(f["nwk_phys"], self.cfg.V),
                self._client.wrap_vector(f["nk"]))


class _SpmdPlane(_SpmdPlaneBase):
    """Training over a ``(data, model)`` mesh of rank processes.

    Workers (all ranks) sample their document partitions
    (``shard_tokens``); servers (the model axis) hold cyclic rows of
    ``n_wk``.  Random streams as the JAX package's SPMD plane: ``key =
    PRNGKey(seed)`` seeds the stacked z init, then per sweep ``key, sub =
    split(key)`` and rank ``r`` takes ``split(sub, workers)[r]``.  The
    perplexity gathers what ``training_perplexity`` needs onto rank 0;
    ``result().state`` holds the whole mesh's tokens and counts."""

    kind = "spmd"

    def __init__(self, corp, cfg, exec_cfg, sweeps, *, seed=0,
                 mesh_model=2, devices=1, log_fn=print,
                 device: Device = None, timeout_s: float = 600.0,
                 transport: Optional[str] = None):
        self.corp = corp
        self.transport = transport
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.sweeps = int(sweeps)
        self.seed = int(seed)
        self.mesh_model = int(mesh_model)
        self.devices = int(devices)
        self.log_fn = log_fn
        self.device = resolve_device(device)
        self.timeout_s = timeout_s
        self.info: dict = {}
        self.t0 = time.time()
        self._ready = False

    def setup(self):
        if self._ready:
            return
        self._ready = True
        data, model, workers, cfg = _resolve_mesh(self.cfg, self.mesh_model,
                                                  self.devices)
        self.workers = workers
        self.cfg = cfg
        self.log_fn(f"[lda] mesh data={data} x model={model} "
                    f"({workers} workers, {model} servers)")
        route = self.exec_cfg.resolve_route(cfg.V)
        self.info = {"mode": "spmd", "mesh_data": data, "mesh_model": model,
                     "workers": workers,
                     "staleness": self.exec_cfg.staleness,
                     "route": repr(route)}
        self._start({"kind": "spmd", "cfg": cfg,
                     "exec_cfg": dataclasses.replace(self.exec_cfg, obs=None),
                     "seed": self.seed, "data": data, "model": model,
                     "corpus": self.corp})
        self.num_tokens = int(self.corp.num_tokens)
        self.t0 = time.time()

    def schedule(self):
        return range(self.sweeps)

    def step(self, i: int):
        from repro_torch.ps.spmd_worker import OP_SWEEP
        self.run.do(OP_SWEEP, i)
        self.steps_done = i + 1

    def view(self, i: int) -> SweepView:
        nwk, nk = self._view_handles(i + 1)
        return SweepView(self, step=i + 1, epoch=0, pos=i, shard_id=None,
                         is_last=(i == self.sweeps - 1), state=None,
                         nwk=nwk, nk=nk,
                         tokens_seen=self.num_tokens * (i + 1))

    def history_row(self, view, p: float) -> dict:
        return {"sweep": view.step, "perplexity": p,
                "elapsed_s": view.elapsed_s}

    def log_line(self, view, p: float) -> str:
        return (f"[lda] sweep {view.step:4d}  perplexity {p:9.2f}  "
                f"({view.elapsed_s:.1f}s)")

    def checkpoint(self, view, path: str):
        raise ValueError("checkpointing the SPMD plane is not supported; "
                         "train in-process to checkpoint, or persist the "
                         "final model via TopicModel.save")

    def finish(self, stopped: bool):
        self._finish_run()

    def result(self) -> SessionResult:
        nwk, nk = self._result_handles()
        f = self._final
        state = lda.SamplerState(f["w"], f["d"], f["z"], f["valid"],
                                 f["doc_start"], f["doc_len"], nwk, nk,
                                 f["ndk"])
        return SessionResult(nwk, nk, [], self.info, state, None)


class _StreamSpmdPlane(_SpmdPlaneBase):
    """Each visit feeds ``workers`` consecutive scheduled stream shards to
    the ``workers`` ranks (the uniform padded shard geometry is one
    worker's partition); each rank reads its own shard and writes its own
    ``z`` file.  Correctness anchor: the exactly-once conservation law --
    after any number of epochs the global counts equal the histogram of
    the persisted assignments."""

    kind = "stream_spmd"

    def __init__(self, reader, cfg, exec_cfg, epochs, *, seed=0,
                 mesh_model=2, devices=1, max_shards=None, log_fn=print,
                 device: Device = None, timeout_s: float = 600.0,
                 transport: Optional[str] = None):
        self.transport = transport
        if isinstance(reader, str):
            reader = stream_mod.ShardedCorpusReader(reader)
        self.reader = reader
        self.cfg = cfg
        self.exec_cfg = exec_cfg
        self.epochs = int(epochs)
        self.seed = int(seed)
        self.mesh_model = int(mesh_model)
        self.devices = int(devices)
        self.max_shards = max_shards
        self.log_fn = log_fn
        self.device = resolve_device(device)
        self.timeout_s = timeout_s
        self.info: dict = {}
        self.t0 = time.time()
        self._ready = False

    def setup(self):
        if self._ready:
            return
        self._ready = True
        data, model, workers, cfg = _resolve_mesh(self.cfg, self.mesh_model,
                                                  self.devices)
        self.workers = workers
        meta = self.reader.meta
        if meta.num_shards % workers:
            raise ValueError(
                f"stream has {meta.num_shards} shards but the SPMD "
                f"backend consumes groups of {workers} (= mesh "
                f"data x model) per sweep; re-shard the stream so the "
                f"shard count is a multiple of {workers}, or adjust "
                f"mesh_model/--devices")
        if meta.tokens_per_shard % cfg.block_tokens:
            raise ValueError(
                f"tokens_per_shard={meta.tokens_per_shard} must be a "
                f"multiple of block_tokens={cfg.block_tokens} for "
                f"the snapshot executor")
        self.cfg = cfg
        self.log_fn(f"[lda] mesh data={data} x model={model} "
                    f"({workers} workers, {model} servers); stream of "
                    f"{meta.num_shards} shards in groups of {workers}")
        route = self.exec_cfg.resolve_route(cfg.V)
        self.info = {"mode": "stream_spmd", "mesh_data": data,
                     "mesh_model": model, "workers": workers,
                     "stream_shards": meta.num_shards,
                     "tokens_per_shard": meta.tokens_per_shard,
                     "num_tokens": meta.num_tokens,
                     "staleness": self.exec_cfg.staleness,
                     "route": repr(route)}
        nwk, nk = init_stream(self.reader, cfg, self.seed, device=self.device)
        loader = stream_mod.StreamingLoader(self.reader, seed=self.seed,
                                            prefetch=False)
        self._sched = loader.schedule(stream_mod.Cursor(0, 0), self.epochs)
        self.total_visits = len(self._sched)
        if self.max_shards is not None:
            self.total_visits = min(self.total_visits, self.max_shards)
        self._start({"kind": "stream_spmd", "cfg": cfg,
                     "exec_cfg": dataclasses.replace(self.exec_cfg, obs=None),
                     "seed": self.seed, "data": data, "model": model,
                     "stream_dir": self.reader.path, "epochs": self.epochs},
                    init=(nwk.value, nk.value))
        del nwk, nk
        self._tokens = [self.reader.shard(s, load_z=False).n_tokens
                        for s in range(meta.num_shards)]
        self.shards_done = 0
        self.tokens_seen = 0
        self.t0 = time.time()

    def schedule(self):
        for g in range(0, len(self._sched) // self.workers):
            yield g

    def _group(self, g: int):
        return self._sched[g * self.workers:(g + 1) * self.workers]

    def step(self, g: int):
        from repro_torch.ps.spmd_worker import OP_VISIT
        self.run.do(OP_VISIT, g)
        self.steps_done = g + 1
        group = self._group(g)
        self.shards_done += len(group)
        self.tokens_seen += sum(self._tokens[sid] for _, sid in group)

    def view(self, g: int) -> SweepView:
        # step counts *shard visits* (not groups), so eval cadences mean
        # the same thing as on the in-process stream plane; callbacks fire
        # on crossing a multiple, since steps advance by ``workers``
        cur0 = self._group(g)[0][0]
        nwk, nk = self._view_handles(g + 1)
        return SweepView(self, step=self.shards_done,
                         epoch=cur0.epoch, pos=cur0.pos, shard_id=None,
                         is_last=(self.shards_done >= self.total_visits),
                         state=None, nwk=nwk, nk=nk,
                         tokens_seen=self.tokens_seen)

    def history_row(self, view, p: float) -> dict:
        el = view.elapsed_s
        return {"epoch": view.epoch, "pos": view.pos, "perplexity": p,
                "elapsed_s": el, "tokens_per_s": self.tokens_seen / el}

    def log_line(self, view, p: float) -> str:
        el = view.elapsed_s
        return (f"[stream] epoch {view.epoch} group at pos {view.pos:3d}  "
                f"perplexity {p:9.2f}  "
                f"({self.tokens_seen / el:,.0f} tok/s)")

    def checkpoint(self, view, path: str):
        raise ValueError("checkpointing the streamed SPMD plane is not "
                         "supported yet; train in-process to checkpoint")

    def should_stop(self) -> bool:
        return (self.max_shards is not None
                and self.shards_done >= self.max_shards)

    def finish(self, stopped: bool):
        self._finish_run()
        if self.shards_done:
            el = time.time() - self.t0
            self.log_fn(f"[stream] done: {self.shards_done} shard visits "
                        f"({self.workers} per sweep), {self.tokens_seen} "
                        f"tokens in {el:.1f}s "
                        f"({self.tokens_seen / el:,.0f} tok/s)")

    def result(self) -> SessionResult:
        nwk, nk = self._result_handles()
        return SessionResult(nwk, nk, [], self.info, None, self.reader)


# ---------------------------------------------------------------------------
# Session: LDAJob -> plane -> result.
# ---------------------------------------------------------------------------

class Session:
    """Resolve a validated ``LDAJob`` into the memory, tiered, stream, SPMD
    or net plane and run it on ``device`` (the card unless the caller
    passes another; the net plane's workers sweep there, and so do the
    SPMD ranks).  ``devices`` is the SPMD rank count, the port's
    counterpart of the JAX package's device count (None:
    ``default_devices``); the other planes ignore it.

    ``run(callbacks)`` executes the schedule and returns a
    ``SessionResult``, with the job's eval cadence wired in as the first
    callback and its checkpoint policy as the last.  ``make_step()``
    exposes the in-memory executor for timing loops.  A job that needs a
    plane the port does not have would be refused here, before any device
    work (``unported_planes``; none is left).
    """

    def __init__(self, job: LDAJob, log_fn=print, device: Device = None,
                 devices: Optional[int] = None):
        self.job = job.validate()
        problems = unported_planes(job)
        if problems:
            raise JobValidationError(problems)
        self.device = resolve_device(device)
        self.devices = (default_devices(self.device) if devices is None
                        else int(devices))
        self.log_fn = log_fn
        self._plane = None
        self.cfg: Optional[lda.LDAConfig] = None

    def _ensure_plane(self):
        if self._plane is not None:
            return self._plane
        job, dev = self.job, self.device
        if job.source_kind == "stream":
            reader = stream_mod.ShardedCorpusReader(job.stream_dir)
            vocab = reader.meta.vocab_size
            if job.vocab_size is not None and job.vocab_size != vocab:
                self.log_fn(f"[api] stream vocab {vocab} overrides "
                            f"vocab_size={job.vocab_size}")
            self.cfg = job.lda_config(vocab)
            if job.backend == SPMD:
                self._plane = _StreamSpmdPlane(
                    reader, self.cfg, job.exec_config(), job.epochs,
                    seed=job.seed, mesh_model=job.mesh_model,
                    devices=self.devices, max_shards=job.max_shards,
                    log_fn=self.log_fn, device=dev)
                return self._plane
            if job.backend == NET:
                self._plane = _NetPlane(reader, self.cfg, job.exec_config(),
                                        job.epochs, job, log_fn=self.log_fn,
                                        device=dev)
                return self._plane
            self._plane = _StreamPlane(
                reader, self.cfg, job.exec_config(), job.epochs,
                seed=job.seed, checkpoint_path=job.checkpoint.path or None,
                resume=job.checkpoint.resume, max_shards=job.max_shards,
                prefetch=job.prefetch, log_fn=self.log_fn, device=dev)
            return self._plane
        corp = job.materialize_corpus()
        vocab = corp.vocab_size if job.vocab_size is None else job.vocab_size
        if vocab < corp.vocab_size:
            raise JobValidationError(
                [f"vocab_size={vocab} is smaller than the corpus "
                 f"vocabulary ({corp.vocab_size}); drop vocab_size= to "
                 f"infer it from the corpus"])
        cfg = job.lda_config(vocab)
        self.cfg = cfg
        if job.backend == SPMD:
            self._plane = _SpmdPlane(corp, cfg, job.exec_config(), job.sweeps,
                                     seed=job.seed, mesh_model=job.mesh_model,
                                     devices=self.devices, log_fn=self.log_fn,
                                     device=dev)
            return self._plane
        if job.backend == NET:
            # a sweep over the materialised corpus == one stream epoch
            self._plane = _NetPlane(corp, cfg, job.exec_config(), job.sweeps,
                                    job, log_fn=self.log_fn, device=dev)
            return self._plane
        if job.storage == "tiered":
            self._plane = _TieredPlane(corp, cfg, job.exec_config(),
                                       job.sweeps, job, log_fn=self.log_fn,
                                       device=dev)
            return self._plane
        key = jrng.PRNGKey(job.seed, dev)
        state = lda.init_state(key, torch.from_numpy(corp.w).to(dev),
                               torch.from_numpy(corp.d).to(dev),
                               corp.num_docs, cfg)
        key, sub = ops.split(key)
        self._plane = _MemoryPlane(cfg, job.exec_config(), state, sub,
                                   job.sweeps, log_fn=self.log_fn)
        return self._plane

    def run(self, callbacks: Sequence[Callback] = ()) -> SessionResult:
        plane = self._ensure_plane()
        cbs: List[Callback] = []
        ev = None
        if self.job.eval_every:
            ev = EvalCallback(every=self.job.eval_every,
                              include_last=plane.kind in ("memory",
                                                          "tiered", "spmd"),
                              log_fn=self.log_fn)
            cbs.append(ev)
        cbs.extend(callbacks)
        if self.job.checkpoint.path:
            cbs.append(CheckpointCallback(self.job.checkpoint.path,
                                          every=self.job.checkpoint.every))
        # job.obs enabled: install the telemetry session for the fit and
        # save trace/metrics under obs.out_dir on exit (no-op otherwise)
        with _obs.session(self.job.obs if self.job.obs.enabled else None):
            res = _run_loop(plane, cbs)
        # cfg may have been refined during setup (the SPMD shard count)
        self.cfg = plane.cfg
        return res._replace(history=ev.history if ev is not None else [])

    def make_step(self):
        """Timing access for in-memory jobs (dense or tiered): returns
        ``(state, step_fn, info)`` with ``step_fn(state, key) -> state`` the
        executor."""
        plane = self._ensure_plane()
        if plane.kind not in ("memory", "tiered"):
            raise ValueError(
                "make_step() exposes the in-memory executor only; drive "
                "other planes through run()")
        plane.setup()
        return plane.state, plane.step_fn, plane.info
