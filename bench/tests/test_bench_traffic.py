"""The corpus generator: deterministic by seed, frequency-ranked, grouped by
document."""
from __future__ import annotations

import json

import pytest
import torch

from bench_cases import ROOT
from bench.traffic import corpus

PARAMS = dict(json.loads((ROOT / "bench" / "traffic" / "pipelined.json")
                         .read_text())["corpus"], docs=200)


def make(seed, vocab=3000):
    return corpus.make_corpus(PARAMS, vocab, seed, torch.device("cpu"))


def test_same_seed_same_arrays_other_seed_other_order():
    a, b, c = make(11), make(11), make(12)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a.w[:1000], c.w[:1000])
    # every seed brings the same documents, in its own order
    assert torch.equal(a.word_freq, c.word_freq)

    def docs(t):
        starts = torch.cumsum(t.doc_len, 0) - t.doc_len
        return sorted(tuple(t.w[s:s + n].tolist())
                      for s, n in zip(starts.tolist(), t.doc_len.tolist()))

    assert docs(a) == docs(c)


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 2**33 + 5])
def test_vocabulary_ranked_by_frequency_and_docs_in_order(seed):
    t = make(seed)
    vocab = t.word_freq.shape[0]
    freq = torch.bincount(t.w.long(), minlength=vocab)
    assert torch.equal(freq, t.word_freq)
    assert bool((freq[:-1] >= freq[1:]).all())
    assert t.w.dtype == t.d.dtype == torch.int32
    assert int(t.w.min()) >= 0 and int(t.w.max()) < vocab
    assert bool((t.d[1:] >= t.d[:-1]).all())
    assert torch.equal(torch.bincount(t.d.long(), minlength=PARAMS["docs"])
                       .to(torch.int32), t.doc_len)
    assert int(t.doc_len.min()) >= PARAMS["min_doc_len"]


def test_lengths_follow_the_mean():
    t = make(3)
    mean = float(t.doc_len.float().mean())
    assert abs(mean - PARAMS["mean_doc_len"]) < 5


def test_every_word_in_use_at_its_zipf_share():
    """Each word's weights over the topics sum to its Zipf share and the
    mixtures' mean is the topics' mass, so the corpus's word marginal is
    the Zipf measure over the whole vocabulary: no word is left out."""
    vocab = 1000
    t = corpus.make_corpus(dict(PARAMS, docs=2000), vocab, 5,
                           torch.device("cpu"))
    assert int((t.word_freq > 0).sum()) == vocab
    zipf = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64) \
        ** PARAMS["zipf"]
    want = zipf / zipf.sum() * t.w.shape[0]
    got = t.word_freq.double()

    def off(a, b):
        return float((a.sum() - b.sum()) / b.sum())

    assert abs(off(got[:10], want[:10])) < 0.02
    assert abs(off(got[vocab // 2:], want[vocab // 2:])) < 0.05
    # by deciles of the ranks; the last is left out, since ranking the
    # words by their own counts puts the rarest draws last
    for k in range(9):
        sl = slice(k * vocab // 10, (k + 1) * vocab // 10)
        assert abs(off(got[sl], want[sl])) < 0.05, k
