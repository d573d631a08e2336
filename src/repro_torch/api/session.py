"""Training session: one visit loop over a data/backend plane.

    plane.setup()
    for visit in plane.schedule():
        plane.step(visit)                 # the only state transition
        callbacks.on_sweep_end(view)      # observation, never perturbation
    callbacks.on_fit_end(final_view)

A *plane* binds a data source to an execution backend.  The port runs the
in-memory corpus on the in-process backend with dense storage
(``_MemoryPlane``); the JAX package's streamed, tiered, SPMD and network
planes belong to later slices, and ``Session`` refuses a job that needs one
with the ROADMAP item that ports it.

Random stream, as the JAX package's memory plane draws it: ``init_state``
draws the initial topics from ``PRNGKey(seed)`` itself, then ``key, sub =
split(key)`` once before the plane, and once more before every sweep.  So
a job's counts equal the JAX package's bitwise.
"""
from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import torch

from repro_torch import obs as _obs
from repro_torch import ps
from repro_torch import rng as jrng
from repro_torch.api.callbacks import Callback, EvalCallback, SweepView
from repro_torch.api.job import NET, SPMD, JobValidationError, LDAJob
from repro_torch.core import lightlda as lda
from repro_torch.core import perplexity as ppl
from repro_torch.device import Device, resolve_device
from repro_torch.train import async_exec


class SessionResult(NamedTuple):
    """What a finished run hands back: the final PS handles, the eval
    callback's ``history`` rows, the executor's realised schedule
    (``info``) and the final ``SamplerState``.  ``reader`` (a streamed
    run's reader in the JAX package) is always None here."""

    nwk: "ps.MatrixHandle"
    nk: "ps.VectorHandle"
    history: list
    info: dict
    state: Optional["lda.SamplerState"]
    reader: None


def unported_planes(job: LDAJob) -> List[str]:
    """Why the port cannot run ``job`` yet, one line per plane it needs
    (empty: the memory x in-process x dense plane runs it)."""
    out = []
    if job.source_kind == "stream":
        out.append("a streamed source (stream_dir=) is not ported yet: "
                   "ROADMAP A, 'Streaming and checkpointing'")
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
    if job.checkpoint.path:
        out.append("checkpoint.path is not ported yet: ROADMAP A, "
                   "'Streaming and checkpointing'")
    return out


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
# Session: LDAJob -> plane -> result.
# ---------------------------------------------------------------------------

class Session:
    """Resolve a validated ``LDAJob`` into the memory plane and run it on
    ``device`` (the card unless the caller passes another).

    ``run(callbacks)`` executes the schedule and returns a
    ``SessionResult``, with the job's eval cadence wired in as the first
    callback.  ``make_step()`` exposes the executor for timing loops.  A
    job that needs a plane the port does not have yet is refused here,
    before any device work, with the ROADMAP item that ports it.
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
            ev = EvalCallback(every=self.job.eval_every, include_last=True,
                              log_fn=self.log_fn)
            cbs.append(ev)
        cbs.extend(callbacks)
        # job.obs enabled: install the telemetry session for the fit and
        # save trace/metrics under obs.out_dir on exit (no-op otherwise)
        with _obs.session(self.job.obs if self.job.obs.enabled else None):
            res = _run_loop(plane, cbs)
        return res._replace(history=ev.history if ev is not None else [])

    def make_step(self):
        """Timing access: returns ``(state, step_fn, info)`` with
        ``step_fn(state, key) -> state`` the executor."""
        plane = self._ensure_plane()
        plane.setup()
        return plane.state, plane.step_fn, plane.info
