"""Double-buffered model snapshot publication.

The serving-side analogue of the paper's asynchronous pull (section 2.3):
training keeps updating the live count tables while serving reads a
*consistent, bounded-stale* model.  Consistency comes from immutability -- a
``Snapshot`` is a frozen value ``(n_wk, n_k, alias tables, φ)`` built from
one set of counts -- and bounded staleness from the publisher: readers
always see the latest *published* version.

Double buffering: the publisher owns two snapshot slots, builds the next
snapshot into the slot readers are NOT holding, then flips the active index
in a single reference store.  Readers (``acquire``) never block and never
observe a half-built snapshot.  The version counter is strictly monotonic.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

from repro_torch import obs as _obs
from repro_torch.core import lightlda as lda
from repro_torch.core import perplexity as ppl

if TYPE_CHECKING:
    from repro_torch import ps


class Snapshot(NamedTuple):
    """One immutable published model version.

    ``model`` carries the frozen counts + alias tables the fold-in sampler
    consumes; ``phi`` is the smoothed topic-word matrix used for scoring
    (φ_wk = (n_wk+β)/(n_k+Vβ)); ``p_coll`` is the collection unigram model
    p(w|C) used by query-likelihood smoothing.
    """

    version: int
    model: lda.FrozenModel
    phi: torch.Tensor      # [V, K] float32
    p_coll: torch.Tensor   # [V]    float32, collection language model
    cfg: lda.LDAConfig

    @property
    def theta_prior(self) -> float:
        return self.cfg.alpha

    @property
    def device(self) -> torch.device:
        return self.phi.device

    def to(self, device) -> "Snapshot":
        return Snapshot(self.version, self.model.to(device),
                        self.phi.to(device), self.p_coll.to(device), self.cfg)


def build_snapshot(nwk_dense: torch.Tensor, nk: torch.Tensor,
                   cfg: lda.LDAConfig, version: int) -> Snapshot:
    """Freeze dense counts into a ``Snapshot`` (alias tables + φ + p(w|C)),
    on the device the counts lie on.

    φ doubles as the word-proposal weights (same smoothed matrix), so it is
    computed once and shared with the alias build -- on a card, one launch
    of the ``alias_build`` kernel."""
    nwk_f = nwk_dense.to(torch.float32)
    nk_f = nk.to(torch.float32)
    phi = ppl.phi_from_counts(nwk_f, nk_f, cfg.beta)
    model = lda.freeze_model(nwk_f, nk_f, cfg, weights=phi)
    freq = model.nwk.sum(1)
    p_coll = (freq + 1.0) / (freq.sum() + cfg.V)       # add-one smoothed
    return Snapshot(version, model, phi, p_coll, cfg)


class SnapshotPublisher:
    """Training-to-serving handoff with monotonic versions.

    ``publish`` is called by whoever owns the counts; ``acquire`` from any
    number of serving threads.  Publication cost is the O(V*K) alias build,
    amortised over every request served from that snapshot.
    """

    def __init__(self, cfg: lda.LDAConfig):
        self.cfg = cfg
        self._slots: list = [None, None]
        self._active: int = -1          # -1: nothing published yet
        self._version: int = 0
        self._publish_lock = threading.Lock()

    def publish(self, nwk_dense: torch.Tensor, nk: torch.Tensor) -> Snapshot:
        """Build and atomically publish the next version from dense counts.

        Obs spans split the cost into ``snapshot.build`` (φ + alias tables
        + p(w|C) dispatch), ``snapshot.sync`` (awaiting the device work) and
        ``snapshot.swap`` (the reference flip).  Published values are
        identical with tracing on or off.
        """
        with self._publish_lock:
            target = 1 - self._active if self._active >= 0 else 0
            version = self._version + 1
            with _obs.span("snapshot.build", cat="snapshot",
                           version=version):
                snap = build_snapshot(nwk_dense, nk, self.cfg, version)
            with _obs.span("snapshot.sync", cat="snapshot",
                           version=version):
                if snap.model.aprob.is_cuda:            # built pre-flip
                    torch.cuda.synchronize(snap.model.aprob.device)
            with _obs.span("snapshot.swap", cat="snapshot",
                           version=version):
                # Order matters for lock-free readers: the slot is filled
                # first, the active index flips second, and the version
                # counter advances LAST.  A reader that observes
                # ``publisher.version == N`` is therefore guaranteed that
                # ``acquire()`` already returns version N (or newer).
                self._slots[target] = snap
                self._active = target    # the flip: one reference store
                self._version = version
        reg = _obs.metrics_registry()
        if reg is not None:
            reg.gauge("snapshot.version").set(version)
        return snap

    def publish_view(self, view: "ps.ReadOnlyView",
                     nk: "ps.VectorHandle") -> Snapshot:
        """Publish from a read-only view of the training handles (the
        serving-side read: pull, never push).  The ``snapshot.pull`` span
        covers the pull, synchronised."""
        with _obs.span("snapshot.pull", cat="snapshot") as sp:
            dense = sp.sync_on(view.to_dense())
            nk_val = nk.pull_all().result()
        return self.publish(dense, nk_val)

    def publish_state(self, state: "lda.SamplerState") -> Snapshot:
        """Publish straight from a training ``SamplerState``."""
        return self.publish_view(state.nwk.read_view(), state.nk)

    def acquire(self) -> Optional[Snapshot]:
        """Latest published snapshot (never blocks; None before the first
        publish).  Holding the returned value pins that version."""
        active = self._active             # single read: no torn state
        return self._slots[active] if active >= 0 else None

    @property
    def version(self) -> int:
        return self._version
