"""Topic coherence (NPMI) -- the standard intrinsic quality metric for the
"uncovering prevalent themes" claim (paper section 4: the released
1000-topic model's themes).

NPMI over the training corpus's document co-occurrences: for each topic's
top-M words, average the normalised pointwise mutual information of all
word pairs.  Random topics score ~0; coherent topics score > 0.  The
port's own copy (numpy only) of the JAX package's module, used by
``api.EvalCallback(coherence=True)``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def doc_occurrence(w: np.ndarray, d: np.ndarray, vocab_size: int,
                   num_docs: int) -> np.ndarray:
    """Binary doc x word occurrence matrix (bool, dense -- eval scale)."""
    occ = np.zeros((num_docs, vocab_size), bool)
    occ[d, w] = True
    return occ


def topic_npmi(phi: np.ndarray, occ: np.ndarray, top_m: int = 10,
               eps: float = 1e-12, relevance: float = 0.6) -> np.ndarray:
    """NPMI per topic.  phi: [V, K] topic-word distributions.

    Top words are selected by LDAvis-style *relevance*
    ``lam*log phi + (1-lam)*log(phi/p(w))``: with a Zipfian vocabulary, raw
    probability tops every topic with the corpus head (stopword effect,
    all topics ~0), while pure lift (lam=0) over-selects ultra-rare words
    whose zero co-occurrences bottom out NPMI at -1.  lam=0.6 is the
    standard default; pass relevance=1.0 for raw-probability selection.
    """
    num_docs, v = occ.shape
    k = phi.shape[1]
    p_w = occ.mean(0)                               # [V]
    marg = phi.mean(1) + eps                        # corpus word marginal
    lam = relevance
    scores = np.zeros(k)
    for t in range(k):
        logp = np.log(phi[:, t] + eps)
        weight = lam * logp + (1 - lam) * (logp - np.log(marg))
        top = np.argsort(-weight)[:top_m]
        sub = occ[:, top].astype(np.float64)        # [D, M]
        p_pair = (sub.T @ sub) / num_docs           # [M, M]
        total, cnt = 0.0, 0
        for i in range(top_m):
            for j in range(i + 1, top_m):
                pij = p_pair[i, j]
                pi, pj = p_w[top[i]], p_w[top[j]]
                if pij < eps or pi < eps or pj < eps:
                    npmi = -1.0 if pij < eps else 0.0
                else:
                    pmi = np.log(pij / (pi * pj))
                    npmi = pmi / (-np.log(pij))
                total += npmi
                cnt += 1
        scores[t] = total / max(cnt, 1)
    return scores


def mean_coherence(phi: np.ndarray, w: np.ndarray, d: np.ndarray,
                   vocab_size: int, num_docs: int, top_m: int = 10) -> float:
    occ = doc_occurrence(w, d, vocab_size, num_docs)
    return float(topic_npmi(phi, occ, top_m).mean())
