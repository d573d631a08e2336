"""Synthetic Zipfian corpus generation (ClueWeb12 stand-in), numpy only.

The port's own copy of the generator its tests make documents with:
LDA-distributed corpora whose empirical word frequencies are
Zipfian (paper Fig. 4), with a **frequency-ordered** vocabulary (rank 0 = most
common word, the paper's section 3.2 layout) and flattened ``(w, d)`` token
arrays grouped by document.  Same seed, same arrays as the JAX package's
``data/corpus.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Corpus:
    """Flattened corpus, frequency-ordered vocabulary."""

    w: np.ndarray          # [N] word ids
    d: np.ndarray          # [N] doc ids
    doc_start: np.ndarray  # [D]
    doc_len: np.ndarray    # [D]
    vocab_size: int
    word_freq: np.ndarray  # [V] corpus frequency of each word id (desc.)

    @property
    def num_tokens(self) -> int:
        return int(self.w.shape[0])

    @property
    def num_docs(self) -> int:
        return int(self.doc_len.shape[0])


def reindex(w: np.ndarray, d: np.ndarray, vocab_size: int) -> Corpus:
    """Rebuild offsets + frequency ordering for a token list."""
    freq = np.bincount(w, minlength=vocab_size)
    order = np.argsort(-freq, kind="stable")
    rank_of = np.empty_like(order)
    rank_of[order] = np.arange(vocab_size)
    w = rank_of[w].astype(np.int32)
    freq = freq[order]

    uniq, d_new = np.unique(d, return_inverse=True)
    sort = np.argsort(d_new, kind="stable")
    w, d_new = w[sort], d_new[sort].astype(np.int32)
    doc_len = np.bincount(d_new, minlength=len(uniq)).astype(np.int32)
    return Corpus(w, d_new, _starts_of(doc_len), doc_len, vocab_size, freq)


def generate_lda_corpus(seed: int, num_docs: int, mean_doc_len: int,
                        vocab_size: int, num_topics: int,
                        zipf_exponent: float = 1.05,
                        doc_topic_alpha: float = 0.08,
                        topic_concentration: float = 2000.0) -> Corpus:
    """Generate a corpus from the LDA generative process with a Zipfian base
    measure, so empirical frequencies follow Zipf's law (paper Fig. 4)."""
    rng = np.random.default_rng(seed)

    base = 1.0 / np.arange(1, vocab_size + 1) ** zipf_exponent
    base /= base.sum()
    phi = rng.dirichlet(base * topic_concentration, size=num_topics)  # [K, V]

    doc_lens = np.maximum(rng.poisson(mean_doc_len, size=num_docs), 4)
    thetas = rng.dirichlet(np.full(num_topics, doc_topic_alpha), size=num_docs)

    ws: List[np.ndarray] = []
    ds: List[np.ndarray] = []
    for doc in range(num_docs):
        n = doc_lens[doc]
        zs = rng.choice(num_topics, size=n, p=thetas[doc])
        wdoc = np.empty(n, dtype=np.int64)
        for k in np.unique(zs):
            m = zs == k
            wdoc[m] = rng.choice(vocab_size, size=m.sum(), p=phi[k])
        ws.append(wdoc)
        ds.append(np.full(n, doc, dtype=np.int64))

    return reindex(np.concatenate(ws), np.concatenate(ds), vocab_size)


def synthetic_corpus(num_docs: int, vocab_size: int, *,
                     true_topics: Optional[int] = None,
                     model_topics: Optional[int] = None,
                     mean_doc_len: int = 60, seed: int = 0,
                     log_fn=None) -> Corpus:
    """The canonical synthetic-corpus recipe: ``true_topics`` defaults to
    ``max(4, model_topics // 2)``, or 16 if neither is given."""
    if true_topics is None:
        true_topics = max(4, model_topics // 2) if model_topics else 16
    corp = generate_lda_corpus(seed=seed, num_docs=num_docs,
                               mean_doc_len=mean_doc_len,
                               vocab_size=vocab_size,
                               num_topics=true_topics)
    if log_fn is not None:
        log_fn(f"corpus: {corp.num_tokens} tokens, {corp.num_docs} docs, "
               f"V={corp.vocab_size}")
    return corp


def _starts_of(doc_len: np.ndarray) -> np.ndarray:
    """Offsets from lengths; an empty doc set has *empty* offsets."""
    if doc_len.shape[0] == 0:
        return np.zeros(0, np.int32)
    return np.concatenate([[0], np.cumsum(doc_len)[:-1]]).astype(np.int32)
