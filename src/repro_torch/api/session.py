"""Training session: one visit loop over a data/backend plane.

    plane.setup()
    for visit in plane.schedule():
        plane.step(visit)                 # the only state transition
        callbacks.on_sweep_end(view)      # observation, never perturbation
    callbacks.on_fit_end(final_view)

A *plane* binds a data source to an execution backend.  The port runs two,
both on the in-process backend with dense storage: the in-memory corpus
(``_MemoryPlane``) and the on-disk shard stream (``_StreamPlane``, the
out-of-core trainer).  The JAX package's tiered, SPMD and network planes
belong to later slices, and ``Session`` refuses a job that needs one with
the ROADMAP item that ports it.

Random streams, as the JAX package draws them, so a job's counts equal its
bitwise:

  * memory: ``init_state`` draws the initial topics from ``PRNGKey(seed)``
    itself, then ``key, sub = split(key)`` once before the plane, and once
    more before every sweep;
  * stream: every draw derives from the base seed through ``fold_in``
    chains keyed by *schedule position* (``stream_init_key``,
    ``stream_sweep_key``), never by host iteration state -- which is what
    makes resume bitwise.
"""
from __future__ import annotations

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
    """Why the port cannot run ``job`` yet, one line per plane it needs
    (empty: the memory x in-process x dense plane runs it)."""
    out = []
    if job.backend == SPMD:
        out.append("backend='spmd' is not ported yet: ROADMAP A, 'SPMD'")
    if job.backend == NET:
        out.append("backend='net' is not ported yet: ROADMAP A, "
                   "'Network parameter server'")
    if job.storage == "tiered":
        out.append("storage='tiered' is not ported yet: ROADMAP A, "
                   "'Tiered storage'")
    if job.route == "auto" or job.staleness == "auto":
        out.append("route='auto'/staleness='auto' is not ported yet: "
                   "ROADMAP A, 'Autotuner'")
    return out


# ---------------------------------------------------------------------------
# Stream random streams: every draw derives from one base seed through
# ``fold_in`` chains keyed by schedule position.
# ---------------------------------------------------------------------------

def stream_init_key(seed: int, shard_id: int,
                    device: Device = "cpu") -> torch.Tensor:
    """Key for shard ``shard_id``'s initial topic assignment draw."""
    base = jrng.fold_in(jrng.PRNGKey(seed, device), 0)
    return jrng.fold_in(base, shard_id)


def stream_sweep_key(seed: int, epoch: int, pos: int,
                     device: Device = "cpu") -> torch.Tensor:
    """Key for the sweep at schedule position (epoch, pos)."""
    base = jrng.fold_in(jrng.PRNGKey(seed, device), 1)
    return jrng.fold_in(jrng.fold_in(base, epoch), pos)


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
        z = jrng.randint(stream_init_key(seed, sid, dev),
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


# ---------------------------------------------------------------------------
# The generic visit loop.
# ---------------------------------------------------------------------------

def _run_loop(plane, callbacks: Sequence[Callback]) -> SessionResult:
    # Spans cover the host side of each visit -- the executor step
    # (``session.step``) and the observers (``session.callbacks``); with no
    # obs session each is the no-op NULL_SPAN.
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
        self.key, sub = jrng.split(self.key)
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
    host token index), ``stream.h2d``, ``stream.ndk``, the executor's
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
        self.loader = stream_mod.StreamingLoader(reader, seed=self.seed,
                                                 prefetch=self.prefetch)
        self.total_visits = len(self.loader.schedule(cursor, self.epochs))
        if self.max_shards is not None:
            self.total_visits = min(self.total_visits, self.max_shards)
        self.valid_np = np.arange(meta.tokens_per_shard)
        self.valid_dev = torch.arange(meta.tokens_per_shard, device=dev)
        self.shards_done = 0
        self.tokens_seen = 0
        self.state: Optional[lda.SamplerState] = None
        self.t0 = time.time()

    def schedule(self):
        return self.loader.iterate(self.cursor0, self.epochs)

    def step(self, visit):
        cur, sid, shard = visit
        cfg, meta, dev = self.cfg, self.reader.meta, self.device
        if shard.z is None:
            raise FileNotFoundError(
                f"shard {sid} has no z file; stream was never initialised")
        n = shard.n_tokens
        index = ()
        if self.build_index is not None:
            with _obs.span("stream.index", cat="stream", shard=sid):
                index = self.build_index(shard.w, self.valid_np < n)
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
        state = self.step_fn(state, key, *index)
        with _obs.span("stream.write_z", cat="stream", shard=sid):
            self.reader.write_z(sid, state.z.cpu().numpy())
        self.state = state
        self.nwk, self.nk = state.nwk, state.nk
        self.shards_done += 1
        self.tokens_seen += n
        self.final_cursor = cur.next(meta.num_shards)

    def view(self, visit) -> SweepView:
        cur, sid, shard = visit
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
# Session: LDAJob -> plane -> result.
# ---------------------------------------------------------------------------

class Session:
    """Resolve a validated ``LDAJob`` into the memory or the stream plane
    and run it on ``device`` (the card unless the caller passes another).

    ``run(callbacks)`` executes the schedule and returns a
    ``SessionResult``, with the job's eval cadence wired in as the first
    callback and its checkpoint policy as the last.  ``make_step()``
    exposes the in-memory executor for timing loops.  A job that needs a
    plane the port does not have yet is refused here, before any device
    work, with the ROADMAP item that ports it.
    """

    def __init__(self, job: LDAJob, log_fn=print, device: Device = None):
        self.job = job.validate()
        problems = unported_planes(job)
        if problems:
            raise JobValidationError(problems)
        self.device = resolve_device(device)
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
        key = jrng.PRNGKey(job.seed, dev)
        state = lda.init_state(key, torch.from_numpy(corp.w).to(dev),
                               torch.from_numpy(corp.d).to(dev),
                               corp.num_docs, cfg)
        key, sub = jrng.split(key)
        self._plane = _MemoryPlane(cfg, job.exec_config(), state, sub,
                                   job.sweeps, log_fn=self.log_fn)
        self.cfg = cfg
        return self._plane

    def run(self, callbacks: Sequence[Callback] = ()) -> SessionResult:
        plane = self._ensure_plane()
        cbs: List[Callback] = []
        ev = None
        if self.job.eval_every:
            ev = EvalCallback(every=self.job.eval_every,
                              include_last=plane.kind == "memory",
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
        return res._replace(history=ev.history if ev is not None else [])

    def make_step(self):
        """Timing access for in-memory jobs: returns ``(state, step_fn,
        info)`` with ``step_fn(state, key) -> state`` the executor."""
        plane = self._ensure_plane()
        if plane.kind != "memory":
            raise ValueError(
                "make_step() exposes the in-memory executor only; drive "
                "other planes through run()")
        plane.setup()
        return plane.state, plane.step_fn, plane.info
