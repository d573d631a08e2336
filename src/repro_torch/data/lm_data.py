"""Synthetic LM data for the training path: the twin of the JAX package's
``data/lm_data.py``, plain numpy, so from the same seed its batches equal
the JAX package's bitwise.

Token frequencies are drawn Zipfian (like the paper's corpus, Fig. 4), and
the sequences have *learnable structure*: a random order-1 Markov chain over
the vocabulary (peaked transitions), which a few hundred steps of a ~100M
model can visibly compress.

Host-side numpy generators yielding dict batches; the trainer moves them to
its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    zipf_exponent: float = 1.1
    branching: int = 4          # Markov out-degree (lower = more learnable)
    seed: int = 0
    cond_len: int = 0           # conditioning stub (vlm/audio); 0 = none
    cond_dim: int = 0


class MarkovZipfSource:
    """Order-1 Markov chain whose stationary distribution is ~Zipfian."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        base = 1.0 / np.arange(1, v + 1) ** cfg.zipf_exponent
        base /= base.sum()
        # each token transitions to `branching` successors, biased to the
        # head.  The reference draws them as V calls of
        # ``rng.choice(v, size=branching, p=base)``, each of which builds
        # the normalised cdf of ``base`` and searches it with ``branching``
        # uniforms; one call for all V rows consumes the same uniforms in
        # the same order, so the successors are the same, in O(V) instead
        # of O(V^2) (at gemma3's 262,144 tokens the loop takes minutes)
        cdf = base.cumsum()
        cdf /= cdf[-1]
        self.succ = cdf.searchsorted(rng.random((v, cfg.branching)),
                                     side="right")          # [V, branching]
        self.succ_p = rng.dirichlet(np.full(cfg.branching, 0.5), size=v)
        self.base = base
        self.rng = rng

    def batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b, s = cfg.batch_size, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self.rng.choice(cfg.vocab_size, size=b, p=self.base)
        # the reference's vectorised branch draw, whose result it never
        # uses ("placeholder"): its b * s uniforms come before the per-step
        # loop's, so the draw stays
        self.rng.random((b, s))
        for t in range(s):
            cur = toks[:, t]
            cdf = np.cumsum(self.succ_p[cur], axis=-1)
            k = (self.rng.random((b, 1)) < cdf).argmax(-1)
            toks[:, t + 1] = self.succ[cur, k]
        out = {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((b, s), np.float32),
        }
        if cfg.cond_len:
            out["cond"] = self.rng.standard_normal(
                (b, cfg.cond_len, cfg.cond_dim)).astype(np.float32)
        return out

    def batches(self, n: int) -> Iterator[Dict[str, np.ndarray]]:
        for _ in range(n):
            yield self.batch()


def token_frequencies(source: MarkovZipfSource, num_batches: int = 8
                      ) -> np.ndarray:
    """Empirical token frequencies (rank-ordered check for tests)."""
    counts = np.zeros(source.cfg.vocab_size, np.int64)
    for b in source.batches(num_batches):
        counts += np.bincount(b["tokens"].reshape(-1),
                              minlength=source.cfg.vocab_size)
    return counts
