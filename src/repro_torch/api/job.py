"""Declarative job spec for the estimator API.

An ``LDAJob`` is the single description of a training run -- data source,
model hyperparameters, execution backend, executor schedule, checkpoint
policy, seed -- validated *up front* with actionable errors, before any
device work happens.  ``repro_torch.api.APSLDA(job).fit()`` (or the
lower-level ``Session``) turns it into a trained ``TopicModel``.

The job has every field of the JAX package's except the two that select
its Pallas path (``use_kernels``, ``kernel_interpret``): here a CUDA tensor
always runs the kernel, so a job reads the same in both packages.  The
device is not a field; it is a keyword of ``APSLDA`` and ``Session``,
and so is an SPMD job's rank count (``devices``, the counterpart of the JAX
package's device count).  Every backend of the JAX package runs here: the
SPMD one (``backend="spmd"``) as rank processes over ``torch.distributed``,
the network one (``backend="net"``) as a server and worker processes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Sequence, Union

from repro_torch import ps
from repro_torch.core import lightlda as lda
from repro_torch.obs import ObsConfig
from repro_torch.train.async_exec import ExecConfig

IN_PROCESS = "in_process"
SPMD = "spmd"
NET = "net"
_BACKENDS = (IN_PROCESS, SPMD, NET)
_NET_ASSIGN = ("dynamic", "static", "static_steal")


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """When and where training state persists.

    ``path`` is the checkpoint file; empty disables checkpointing.
    ``every`` is in *visits* -- sweeps for an in-memory source, shard
    visits for a streamed one; 0 means only at the end of ``fit``.
    ``resume=True`` restores from ``path`` and continues
    bitwise-identically (streamed sources only -- the stream keeps the
    full resumable state on disk, paper section 3.5).
    """

    path: str = ""
    every: int = 0
    resume: bool = False

    def problems(self) -> list:
        out = []
        if self.every < 0:
            out.append("checkpoint.every must be >= 0 (0: only at the end "
                       "of fit)")
        if (self.every or self.resume) and not self.path:
            out.append("checkpoint.path is required when checkpoint.every "
                       "or checkpoint.resume is set")
        return out


class JobValidationError(ValueError):
    """An ``LDAJob`` that cannot run, with every problem listed."""

    def __init__(self, problems: Sequence[str]):
        self.problems = list(problems)
        lines = "\n".join(f"  - {p}" for p in self.problems)
        super().__init__(f"invalid LDAJob ({len(self.problems)} "
                         f"problem{'s' if len(self.problems) != 1 else ''}):"
                         f"\n{lines}")


@dataclasses.dataclass(frozen=True)
class LDAJob:
    """One declarative LDA training job, corpus to served model.

    Data source (exactly one):
      ``corpus``      an in-memory ``data.corpus.Corpus``;
      ``stream_dir``  a sharded on-disk stream (``data.stream`` layout);
      ``docs``        an iterable of token-id arrays -- materialised into
                      a frequency-ordered in-memory corpus (note: word ids
                      are *re-ranked by frequency*, the section-3.2
                      contract every downstream component assumes).

    Backend: ``"in_process"`` (single device), ``"spmd"`` (a ``(data,
    model)`` mesh of rank processes with ``mesh_model`` parameter-server
    shards; the rank count is ``APSLDA``/``Session``'s ``devices=``) or
    ``"net"``.

    Schedule: ``sweeps`` full Gibbs sweeps for in-memory sources;
    ``epochs`` passes over the shard stream for streamed ones.
    ``staleness``/``model_blocks``/``route`` are the asynchronous
    executor's knobs (``train.async_exec.ExecConfig``); ``hot_words`` is
    the legacy scalar mapped through ``ps.route_for``.

    Storage: ``"dense"`` keeps the whole ``[V, K]`` count table device-
    resident; ``"tiered"`` keeps only the ``hot_rows`` hottest rows on
    device over a host memmap cold tier (``ps.tiered`` -- the
    vocabulary-past-device-memory axis).  ``hot_rows=None`` auto-sizes
    the hot tier from the corpus word frequencies
    (``ps.autotune.size_hot_rows``); ``tier_dir`` is the cold store's
    directory (None: a temporary directory, deleted with the process);
    ``tier_refresh`` is the sweep cadence of residency refresh (0:
    never).
    """

    # --- data source (exactly one) ---
    corpus: Any = None
    stream_dir: Optional[str] = None
    docs: Optional[Sequence] = None

    # --- model ---
    num_topics: int = 50
    vocab_size: Optional[int] = None      # None: inferred from the source
    alpha: float = 0.1
    beta: float = 0.01
    mh_steps: int = 2
    block_tokens: int = 8192
    num_shards: int = 1                   # PS shards (in-process backend)

    # --- backend ---
    backend: str = IN_PROCESS
    mesh_model: int = 2                   # SPMD: server-axis size
    # net backend (ps.net): a standalone PS process + a pool of
    # worker subprocesses.  ``server`` is a running ``launch.ps_server``
    # address (None: the session embeds one); ``workers`` the pool size;
    # ``net_assign`` the shard re-assignment mode ("dynamic" /
    # "static" / "static_steal" -- see data.leases).
    server: Optional[str] = None
    workers: int = 2
    net_assign: str = "dynamic"

    # --- schedule ---
    sweeps: int = 50                      # in-memory source
    epochs: int = 3                       # streamed source
    staleness: Union[int, str] = 0        # int, or "auto" (ps.autotune)
    model_blocks: int = 0
    route: Optional[Union[ps.PushRoute, str]] = None   # or "auto"
    hot_words: Optional[int] = None
    max_shards: Optional[int] = None      # streamed: stop after N visits
    prefetch: bool = True                 # streamed: double-buffered loader

    # --- parameter storage (ps.tiered) ---
    storage: str = "dense"                # "dense" | "tiered"
    hot_rows: Optional[int] = None        # tiered: device rows (None: auto)
    tier_dir: Optional[str] = None        # tiered: cold-store dir (None: tmp)
    tier_refresh: int = 1                 # tiered: refresh cadence (sweeps)

    # --- policies ---
    checkpoint: CheckpointPolicy = CheckpointPolicy()
    eval_every: int = 10                  # 0: never evaluate
    seed: int = 0
    # telemetry plane (repro_torch.obs): with enabled=True, Session.run
    # installs an obs session for the fit and writes trace.json and
    # metrics.jsonl under obs.out_dir.  Observation only -- the trained
    # model is bitwise identical with tracing on or off.
    obs: ObsConfig = ObsConfig()

    # ------------------------------------------------------------------
    # Source classification
    # ------------------------------------------------------------------
    @property
    def source_kind(self) -> str:
        """``"memory"`` (corpus / docs) or ``"stream"`` (stream_dir)."""
        return "stream" if self.stream_dir is not None else "memory"

    def materialize_corpus(self):
        """The in-memory ``Corpus`` for a memory-source job (builds one
        from ``docs`` if needed; cached so a one-shot iterator still
        supports repeated ``fit`` calls)."""
        if self.corpus is not None:
            return self.corpus
        cached = getattr(self, "_docs_corpus", None)
        if cached is None:
            from repro_torch.data import corpus as corpus_mod
            cached = corpus_mod.corpus_from_docs(self.docs,
                                                 vocab_size=self.vocab_size)
            object.__setattr__(self, "_docs_corpus", cached)
        return cached

    # ------------------------------------------------------------------
    # Validation (up front, every problem reported, each with a fix)
    # ------------------------------------------------------------------
    def problems(self) -> list:
        """Every validation problem, as actionable messages (empty: OK)."""
        out = []
        sources = [s for s, v in [("corpus", self.corpus),
                                  ("stream_dir", self.stream_dir),
                                  ("docs", self.docs)] if v is not None]
        if len(sources) != 1:
            got = ", ".join(sources) if sources else "none"
            out.append(f"exactly one data source required (got: {got}); "
                       "pass corpus=, stream_dir= or docs=")
        if self.stream_dir is not None and not os.path.isdir(self.stream_dir):
            out.append(f"stream_dir {self.stream_dir!r} does not exist; "
                       "write it first (data.stream.write_sharded / "
                       "ShardedCorpusWriter)")

        if self.num_topics < 1:
            out.append(f"num_topics must be >= 1 (got {self.num_topics})")
        if self.vocab_size is not None and self.vocab_size < 1:
            out.append(f"vocab_size must be >= 1 (got {self.vocab_size}); "
                       "or omit it to infer from the data source")
        if self.alpha <= 0 or self.beta <= 0:
            out.append(f"Dirichlet priors must be positive (alpha="
                       f"{self.alpha}, beta={self.beta})")
        if self.mh_steps < 1:
            out.append(f"mh_steps must be >= 1 (got {self.mh_steps})")
        if self.block_tokens < 1:
            out.append(f"block_tokens must be >= 1 (got {self.block_tokens})")
        if self.num_shards < 1:
            out.append(f"num_shards must be >= 1 (got {self.num_shards})")

        if self.backend not in _BACKENDS:
            out.append(f"backend must be one of {_BACKENDS} (got "
                       f"{self.backend!r})")
        if self.backend == SPMD:
            if self.mesh_model < 1:
                out.append(f"mesh_model must be >= 1 (got {self.mesh_model})")
            if self.model_blocks:
                out.append("the SPMD backend uses the full-snapshot "
                           "executor; drop model_blocks= or use "
                           "backend='in_process'")
            if self.num_shards not in (1, self.mesh_model):
                out.append(f"under backend='spmd' the PS shard count is the "
                           f"mesh's model axis ({self.mesh_model}); drop "
                           f"num_shards= (got {self.num_shards})")
            if self.checkpoint.path:
                out.append("checkpointing the SPMD planes is not supported "
                           "yet; drop checkpoint= (persist the final model "
                           "via TopicModel.save) or use "
                           "backend='in_process'")

        if self.backend == NET:
            if self.workers < 1:
                out.append(f"workers must be >= 1 (got {self.workers})")
            if self.net_assign not in _NET_ASSIGN:
                out.append(f"net_assign must be one of {_NET_ASSIGN} (got "
                           f"{self.net_assign!r})")
            if self.num_shards != 1:
                out.append(f"backend='net' requires num_shards=1 (got "
                           f"{self.num_shards}); the standalone server "
                           "holds the whole table")
            if self.storage != "dense":
                out.append("backend='net' requires storage='dense'; the "
                           "server process keeps the table in host memory "
                           "already")
            if self.route == "auto" or self.staleness == "auto":
                out.append("backend='net' does not support route/staleness "
                           "'auto' (the autotuner measures in-process); "
                           "pass concrete values")
            if self.checkpoint.path:
                out.append("checkpointing the net plane is not supported "
                           "yet; the stream's z files plus the server "
                           "counts are the durable state")
            if self.server is not None and self.source_kind != "stream":
                out.append("server= needs a streamed source: the external "
                           "ps_server must be started on the same "
                           "stream_dir the workers read; memory-source "
                           "net jobs embed their own server")
        elif self.server is not None:
            out.append(f"server= only applies to backend='net' (got "
                       f"server={self.server!r} with backend="
                       f"{self.backend!r})")

        if self.sweeps < 1:
            out.append(f"sweeps must be >= 1 (got {self.sweeps})")
        if self.epochs < 1:
            out.append(f"epochs must be >= 1 (got {self.epochs})")
        if isinstance(self.staleness, str):
            if self.staleness != "auto":
                out.append(f"staleness must be an int >= 0 or the string "
                           f"'auto' (got {self.staleness!r})")
        elif self.staleness < 0:
            out.append(f"staleness must be >= 0 (got {self.staleness}); 0 "
                       "is the synchronous schedule")
        if self.model_blocks < 0:
            out.append(f"model_blocks must be >= 0 (got "
                       f"{self.model_blocks}); 0 selects the full-snapshot "
                       "executor")
        if isinstance(self.route, str) and self.route != "auto":
            out.append(f"route must be a ps.PushRoute or the string 'auto' "
                       f"(got {self.route!r})")
        if self.route == "auto" or self.staleness == "auto":
            if self.source_kind != "memory":
                out.append("route='auto'/staleness='auto' needs an "
                           "in-memory source (the autotuner measures "
                           "against the materialised state); pass concrete "
                           "values for streamed jobs")
            if self.backend != IN_PROCESS:
                out.append("route='auto'/staleness='auto' is in_process-"
                           "only (the SPMD planes resolve their schedule "
                           "at shard_map build time); pass concrete values "
                           "under backend='spmd'")
        if self.route is not None and self.hot_words is not None:
            out.append("pass either route= (ps.DenseRoute / ps.CooRoute / "
                       "ps.HybridRoute / 'auto') or the legacy hot_words=, "
                       "not both")
        if self.max_shards is not None:
            if self.source_kind != "stream":
                out.append("max_shards only applies to streamed sources; "
                           "use sweeps= for in-memory training")
            elif self.max_shards < 1:
                out.append(f"max_shards must be >= 1 (got {self.max_shards})")
        if self.checkpoint.resume and self.source_kind != "stream":
            out.append("resume requires a streamed source (the stream "
                       "holds the resumable z state, paper section 3.5); "
                       "for in-memory runs restore via "
                       "train.checkpoint.restore_lda")
        if self.storage not in ("dense", "tiered"):
            out.append(f"storage must be 'dense' or 'tiered' (got "
                       f"{self.storage!r})")
        elif self.storage == "tiered":
            if self.backend != IN_PROCESS:
                out.append("storage='tiered' is in_process-only (the tiered "
                           "store is the single-process scale-up axis, the "
                           "SPMD backend the scale-out one); use "
                           "backend='in_process'")
            if self.num_shards != 1:
                out.append(f"storage='tiered' requires num_shards=1 (got "
                           f"{self.num_shards}); the cold memmap holds the "
                           "whole table, there is nothing to shard")
            if self.source_kind != "memory":
                out.append("storage='tiered' needs an in-memory source "
                           "(corpus= or docs=); the streamed trainer keeps "
                           "its own device-resident model")
            if self.route == "auto" or self.staleness == "auto":
                out.append("storage='tiered' does not support route/"
                           "staleness 'auto' (the autotuner measures "
                           "against dense in-memory handles); pass "
                           "concrete values")
            if self.model_blocks < 1:
                out.append(f"storage='tiered' requires the blocked executor "
                           f"-- set model_blocks >= 1 (e.g. 64; got "
                           f"{self.model_blocks}); pulling the full [V, K] "
                           "snapshot would defeat the tiering")
            if self.checkpoint.path:
                out.append("checkpointing tiered storage is not supported "
                           "yet; drop checkpoint= (the cold store under "
                           "tier_dir persists the table itself)")
            if self.hot_rows is not None and self.hot_rows < 0:
                out.append(f"hot_rows must be >= 0 (got {self.hot_rows}); "
                           "or omit it to auto-size from word frequencies")
            if self.tier_refresh < 0:
                out.append(f"tier_refresh must be >= 0 (got "
                           f"{self.tier_refresh}; 0 disables residency "
                           "refresh)")
        if self.storage == "dense":
            for knob, val in (("hot_rows", self.hot_rows),
                              ("tier_dir", self.tier_dir)):
                if val is not None:
                    out.append(f"{knob}= only applies to storage='tiered' "
                               f"(got {knob}={val!r} with storage='dense')")
        if self.eval_every < 0:
            out.append(f"eval_every must be >= 0 (got {self.eval_every}; "
                       "0 disables evaluation)")
        if not isinstance(self.obs, ObsConfig):
            out.append("obs must be a repro_torch.obs.ObsConfig (got "
                       f"{type(self.obs).__name__})")
        elif self.obs.enabled:
            if not (self.obs.trace or self.obs.metrics):
                out.append("obs.enabled=True with both trace and metrics "
                           "off records nothing; enable at least one or "
                           "drop obs=")
            if not self.obs.out_dir:
                out.append("obs.out_dir is required when obs.enabled=True "
                           "(trace/metrics files are written there)")
        out.extend(self.checkpoint.problems())
        return out

    def validate(self) -> "LDAJob":
        """Raise ``JobValidationError`` listing every problem; returns
        ``self`` so construction and validation chain."""
        probs = self.problems()
        if probs:
            raise JobValidationError(probs)
        return self

    # ------------------------------------------------------------------
    # Resolution into the underlying configs
    # ------------------------------------------------------------------
    def lda_config(self, vocab_size: int) -> lda.LDAConfig:
        """The ``LDAConfig`` for this job at a resolved vocabulary size."""
        num_shards = (self.mesh_model if self.backend == SPMD
                      else self.num_shards)
        return lda.LDAConfig(num_topics=self.num_topics,
                             vocab_size=vocab_size,
                             alpha=self.alpha, beta=self.beta,
                             mh_steps=self.mh_steps,
                             block_tokens=self.block_tokens,
                             num_shards=num_shards)

    def exec_config(self) -> ExecConfig:
        # obs rides along only when explicitly enabled; the disabled
        # default maps to None (= inherit any installed session) so a
        # TraceCallback-owned session still sees the executor's spans
        return ExecConfig(staleness=self.staleness,
                          hot_words=self.hot_words,
                          model_blocks=self.model_blocks,
                          route=self.route,
                          obs=self.obs if self.obs.enabled else None)
