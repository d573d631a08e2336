"""Fitted-model result object: frozen counts with serving entry points.

``TopicModel`` wraps the dense count tables of a trained model plus
everything needed to *use* them:

  * ``transform(docs)``       fold in unseen documents and return their θ;
  * ``score(queries, docs)``  topic-smoothed query-likelihood ranking (the
                              paper's IR use case);
  * ``save`` / ``load``       persist / restore counts + config as npz, in
                              the same layout as the JAX package's
                              ``TopicModel`` (files load in either);
  * ``publisher()``           a ``SnapshotPublisher`` with this model
                              already published.

Everything here is read-only: the expensive alias-table build happens once
(lazily) and is shared by every entry point.  The model lives on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import lightlda as lda
from repro_torch.device import Device, resolve_device
from repro_torch.infer.engine import EngineConfig, QueryEngine
from repro_torch.infer.snapshot import Snapshot, SnapshotPublisher, build_snapshot

# LDAConfig fields of the JAX package that select its Pallas path; the port
# has no such switch (a CUDA tensor always runs the kernel), but its npz
# files carry them so that the JAX package can load them
_JAX_ONLY_CFG = {"use_kernels": False, "kernel_interpret": None}


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array-like (copied: jax
    arrays convert to read-only numpy arrays)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def cfg_to_dict(cfg: lda.LDAConfig) -> dict:
    return {**dataclasses.asdict(cfg), **_JAX_ONLY_CFG}


def cfg_from_dict(cfg_dict: dict) -> lda.LDAConfig:
    return lda.LDAConfig(**{k: v for k, v in cfg_dict.items()
                            if k not in _JAX_ONLY_CFG})


class TopicModel:
    """An immutable fitted LDA model (dense counts + derived serving state).

    ``history`` and ``info`` are observational metadata of the fit that
    produced it, not part of the model.
    """

    def __init__(self, nwk_dense, nk, cfg: lda.LDAConfig, *,
                 history: Optional[list] = None, info: Optional[dict] = None,
                 ecfg: Optional[EngineConfig] = None, device: Device = None):
        self.device = resolve_device(device)
        self._nwk = as_tensor(nwk_dense, self.device)
        self._nk = as_tensor(nk, self.device)
        if tuple(self._nwk.shape) != (cfg.V, cfg.K):
            raise ValueError(f"nwk shape {tuple(self._nwk.shape)} does not "
                             f"match cfg (V={cfg.V}, K={cfg.K})")
        self.cfg = cfg
        self.history = list(history or [])
        self.info = dict(info or {})
        self.ecfg = ecfg or EngineConfig()
        self._snapshot: Optional[Snapshot] = None
        self._engine: Optional[QueryEngine] = None

    # -- raw views ---------------------------------------------------------
    @property
    def num_topics(self) -> int:
        return self.cfg.K

    @property
    def vocab_size(self) -> int:
        return self.cfg.V

    @property
    def nwk(self) -> np.ndarray:
        """Dense [V, K] word-topic counts."""
        return self._nwk.cpu().numpy()

    @property
    def nk(self) -> np.ndarray:
        """[K] topic totals."""
        return self._nk.cpu().numpy()

    @property
    def phi(self) -> np.ndarray:
        """Smoothed topic-word matrix φ_wk = (n_wk+β)/(n_k+Vβ), [V, K]."""
        return self.snapshot.phi.cpu().numpy()

    @property
    def snapshot(self) -> Snapshot:
        """The frozen serving snapshot (alias tables built once, lazily)."""
        if self._snapshot is None:
            self._snapshot = build_snapshot(self._nwk, self._nk, self.cfg,
                                            version=1)
        return self._snapshot

    def engine(self) -> QueryEngine:
        """A batched query engine bound to this model's snapshot."""
        if self._engine is None:
            self._engine = QueryEngine(self.snapshot, self.ecfg)
        return self._engine

    # -- inference ---------------------------------------------------------
    def transform(self, docs: Sequence[np.ndarray],
                  seeds: Optional[Sequence[int]] = None) -> np.ndarray:
        """Fold in unseen documents; returns θ as [len(docs), K].

        ``seeds`` pin each document's fold-in randomness (default: the
        document's position): the same (model, doc, seed) always gives a
        bit-identical θ regardless of batching.
        """
        if seeds is None:
            seeds = list(range(len(docs)))
        results = self.engine().infer(docs, seeds)
        return np.stack([r.theta for r in results])

    def score(self, queries: Sequence[np.ndarray],
              docs: Sequence[np.ndarray],
              seeds: Optional[Sequence[int]] = None) -> np.ndarray:
        """Rank ``docs`` for ``queries``: [num_queries, num_docs] log
        p(q|d) under the topic-smoothed document language model."""
        if seeds is None:
            seeds = list(range(len(docs)))
        eng = self.engine()
        results = eng.infer(docs, seeds)
        return eng.score(results, docs, queries)

    def top_words(self, num_words: int = 8) -> np.ndarray:
        """Top word ids per topic by *lift* (φ_wk / mean_k φ_wk), [K, n]."""
        phi = self.phi
        lift = phi / (phi.mean(axis=1, keepdims=True) + 1e-12)
        return np.argsort(-lift, axis=0)[:num_words].T

    # -- serving handoff ---------------------------------------------------
    def publisher(self) -> SnapshotPublisher:
        """A ``SnapshotPublisher`` with this model published as version 1."""
        pub = SnapshotPublisher(self.cfg)
        pub.publish(self._nwk, self._nk)
        return pub

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Persist counts + config (npz).  The alias tables are derived
        state and are rebuilt on load."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"nwk": self.nwk, "nk": self.nk,
                   "cfg": np.frombuffer(
                       json.dumps(cfg_to_dict(self.cfg)).encode(),
                       dtype=np.uint8)}
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, ecfg: Optional[EngineConfig] = None,
             device: Device = None) -> "TopicModel":
        with np.load(path) as data:
            cfg = cfg_from_dict(json.loads(bytes(data["cfg"]).decode()))
            return cls(data["nwk"], data["nk"], cfg, ecfg=ecfg, device=device)

    def __repr__(self):
        return (f"TopicModel(V={self.cfg.V}, K={self.cfg.K}, "
                f"tokens={int(self._nk.sum())}, device={self.device})")
