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
from typing import List, Optional, Tuple

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

    def subset(self, frac: float, seed: int = 0) -> "Corpus":
        """Take the first ``frac`` of documents (the paper's 2.5%-10%
        subset experiments scale the corpus this way).  ``seed`` is
        unused: the subset is a prefix, as in the reference."""
        ndocs = max(1, int(self.num_docs * frac))
        end = int(self.doc_start[ndocs - 1] + self.doc_len[ndocs - 1])
        return reindex(self.w[:end], self.d[:end], self.vocab_size)


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

    # ``rng.choice(n, size, p=p)`` is ``cdf.searchsorted(rng.random(size),
    # side="right")`` with ``cdf = p.cumsum(); cdf /= cdf[-1]``: the same
    # draws, with each topic's [V] cdf built once instead of per document
    cdfs: dict = {}

    def word_cdf(k):
        if k not in cdfs:
            cdf = phi[k].cumsum()
            cdf /= cdf[-1]
            cdfs[k] = cdf
        return cdfs[k]

    ws: List[np.ndarray] = []
    ds: List[np.ndarray] = []
    for doc in range(num_docs):
        n = doc_lens[doc]
        zs = rng.choice(num_topics, size=n, p=thetas[doc])
        wdoc = np.empty(n, dtype=np.int64)
        for k in np.unique(zs):
            m = zs == k
            wdoc[m] = word_cdf(k).searchsorted(rng.random(m.sum()),
                                               side="right")
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


def corpus_from_docs(docs, vocab_size: Optional[int] = None) -> Corpus:
    """Build a ``Corpus`` from an iterable of token-id documents.

    The entry point behind ``LDAJob(docs=...)``.  NOTE: word ids are
    re-ranked by corpus frequency (``reindex`` -- the section-3.2
    contract every downstream component assumes); keep your own id->rank
    map if you need to translate back.  Empty documents are dropped.
    """
    ws: List[np.ndarray] = []
    ds: List[np.ndarray] = []
    for i, doc in enumerate(docs):
        a = np.asarray(doc, dtype=np.int64).ravel()
        if a.size == 0:
            continue
        ws.append(a)
        ds.append(np.full(a.size, i, np.int64))
    if not ws:
        raise ValueError("docs yielded no tokens; pass at least one "
                         "non-empty document")
    w = np.concatenate(ws)
    d = np.concatenate(ds)
    if w.min() < 0:
        raise ValueError("negative token ids in docs")
    if vocab_size is None:
        vocab_size = int(w.max()) + 1
    elif int(w.max()) >= vocab_size:
        raise ValueError(f"token id {int(w.max())} out of range for "
                         f"vocab_size={vocab_size}")
    return reindex(w, d, vocab_size)


def train_heldout_split(corpus: Corpus, heldout_frac: float = 0.1,
                        seed: int = 1) -> Tuple[Corpus, Corpus]:
    """Split documents into train/held-out sets.  Both keep the parent's
    word ids (``reindex`` would re-rank each split by its own
    frequencies), so that the held-out split is scored in the same id
    space."""
    rng = np.random.default_rng(seed)
    held = rng.random(corpus.num_docs) < heldout_frac
    held_tok = held[corpus.d]
    heldout = Corpus(corpus.w[held_tok].astype(np.int32),
                     _compact_docs(corpus.d[held_tok]),
                     *_offsets(corpus.d[held_tok]),
                     corpus.vocab_size, corpus.word_freq)
    train = Corpus(corpus.w[~held_tok].astype(np.int32),
                   _compact_docs(corpus.d[~held_tok]),
                   *_offsets(corpus.d[~held_tok]),
                   corpus.vocab_size, corpus.word_freq)
    return train, heldout


def _compact_docs(d: np.ndarray) -> np.ndarray:
    _, inv = np.unique(d, return_inverse=True)
    return inv.astype(np.int32)


def _offsets(d: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    dc = _compact_docs(d)
    doc_len = np.bincount(dc).astype(np.int32)
    return _starts_of(doc_len), doc_len


def shard_tokens(corpus: Corpus, num_shards: int, block_tokens: int
                 ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]]:
    """Partition documents across data-parallel workers (Spark partitions,
    paper Fig. 3).  Documents are assigned round-robin by size (greedy LPT)
    so token counts balance; each shard's arrays are padded to
    ``block_tokens``.  Returns per-shard (w, d_local, valid, doc_start,
    doc_len), byte-equal to the JAX package's."""
    order = np.argsort(-corpus.doc_len, kind="stable")
    loads = np.zeros(num_shards, dtype=np.int64)
    assign = np.empty(corpus.num_docs, dtype=np.int32)
    for doc in order:
        s = int(np.argmin(loads))
        assign[doc] = s
        loads[s] += corpus.doc_len[doc]

    shards = []
    for s in range(num_shards):
        docs = np.where(assign == s)[0]
        tok_mask = np.isin(corpus.d, docs)
        w = corpus.w[tok_mask]
        d = _compact_docs(corpus.d[tok_mask])
        doc_start, doc_len = _offsets(corpus.d[tok_mask])
        # every shard pads to at least one full block: an empty shard
        # (num_shards > num_docs) still yields block-shaped, all-invalid
        # arrays
        pad = (-len(w)) % block_tokens
        if len(w) + pad == 0:
            pad = block_tokens
        valid = np.concatenate([np.ones(len(w), bool), np.zeros(pad, bool)])
        w = np.concatenate([w, np.zeros(pad, np.int32)])
        d = np.concatenate([d, np.zeros(pad, np.int32)])
        shards.append((w.astype(np.int32), d.astype(np.int32), valid,
                       doc_start, doc_len))
    return shards


def fold_eval_split(corpus: Corpus, seed: int = 2
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Alternate tokens of each held-out doc into fold-in vs eval halves.
    Returns boolean masks (fold_mask, eval_mask) plus (w, d) unchanged."""
    rng = np.random.default_rng(seed)
    coin = rng.random(corpus.num_tokens) < 0.5
    return corpus.w, corpus.d, coin, ~coin


def doc_term_matrix(corpus: Corpus, docs: np.ndarray) -> np.ndarray:
    """Dense doc-term counts for a batch of docs (online-VB pipeline)."""
    out = np.zeros((len(docs), corpus.vocab_size), np.float32)
    for i, doc in enumerate(docs):
        s, l = corpus.doc_start[doc], corpus.doc_len[doc]
        np.add.at(out[i], corpus.w[s:s + l], 1.0)
    return out
