"""The synthetic corpus every training mix is drawn from, made on the device.

An LDA generative process whose word frequencies follow Zipf's law over
the whole vocabulary, as a frequency-ranked vocabulary's do: every word
keeps its Zipf share, so every one of the ``vocab`` words is in use (the
rarest is expected ~19 times in 32 M tokens).  The outline is
``repro_torch.data.corpus.generate_lda_corpus``'s (topics, Poisson lengths,
Dirichlet mixtures, a frequency-ranked vocabulary); its topics, Dirichlet
draws around the Zipf measure, give a tail word a gamma shape of ~1e-3, so
that most of the tail never occurs.  The topics here follow
``chip_smoke.make_counts``' model instead.  Written in torch, so that a
corpus of tens of millions of tokens is made in a few large calls on the
card from one ``torch.Generator``:

  * each word has a home topic among ``true_topics``; topic k's weight of
    word w is zipf(w) * (``home_share`` if k is w's home, else 0) plus
    zipf(w) * (1 - ``home_share``) / ``true_topics``, with zipf(w) the
    measure 1/r**zipf, so that each word's weights over the topics sum to
    its Zipf share; topic k is its row r_k over the row's sum s_k;
  * document lengths Poisson(``mean_doc_len``), at least ``min_doc_len``;
  * each document's topic mixture Dirichlet(``doc_topic_alpha`` *
    ``true_topics`` * s): its mean is s, so that the corpus's word
    marginal, sum_k s_k r_k / s_k, is the Zipf measure itself; each
    token's topic drawn from the mixture and its word from that topic;
  * word ids re-ranked by corpus frequency (rank 0 the most common word),
    tokens grouped by document in document order.

The documents come from the traffic's fixed ``structure_seed`` and the run's
seed only permutes their order, so that every seed brings the same set of
documents and word frequencies: at 100 topics a seed that drew other
frequencies moved the merge's atomic contention on the hottest words' rows,
and a run's rate by up to 4 %, where two runs of one seed agreed within
0.6 %.  (The program's initial topics and random stream follow the seed.)
The same seed on the same device gives the same arrays.  The parameters are
the traffic file's ``corpus`` object.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Tokens(NamedTuple):
    w: torch.Tensor          # [N] int32 word ids, frequency-ranked
    d: torch.Tensor          # [N] int32 document ids, ascending
    doc_len: torch.Tensor    # [D] int32
    word_freq: torch.Tensor  # [V] int64 corpus count of each word id


def _dirichlet(conc: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    x = torch._standard_gamma(conc, generator=g)
    return x / x.sum(-1, keepdim=True)


def make_corpus(p: dict, vocab: int, seed: int, device) -> Tokens:
    g = torch.Generator(device=device).manual_seed(int(p["structure_seed"]))
    f64 = dict(dtype=torch.float64, device=device)
    topics, docs = int(p["true_topics"]), int(p["docs"])

    base = 1.0 / torch.arange(1, vocab + 1, **f64) ** float(p["zipf"])
    base /= base.sum()
    home = torch.randint(0, topics, (vocab,), generator=g, device=device)
    share = float(p["home_share"])
    phi = torch.full((topics, vocab), (1.0 - share) / topics, **f64)
    phi[home, torch.arange(vocab, device=device)] += share
    phi *= base
    mass = phi.sum(1)
    phi /= mass[:, None]
    lens = torch.poisson(torch.full((docs,), float(p["mean_doc_len"]), **f64),
                         generator=g)
    lens = torch.clamp_min(lens, int(p["min_doc_len"])).to(torch.int64)
    theta = _dirichlet((float(p["doc_topic_alpha"]) * topics * mass)
                       .expand(docs, topics).contiguous(), g)

    # every document draws as many topics as the longest one; its first
    # doc_len of them are its tokens'
    longest = int(lens.max())
    z = torch.multinomial(theta, longest, replacement=True, generator=g)
    z = z[torch.arange(longest, device=device)[None, :] < lens[:, None]]
    # a token's word from its topic's cdf: the topics' cdfs laid end to end,
    # topic t's shifted by t, are one sorted array
    cdf = torch.cumsum(phi, 1)
    cdf /= cdf[:, -1:].clone()
    flat = (cdf + torch.arange(topics, **f64)[:, None]).reshape(-1)
    u = torch.rand(z.shape[0], generator=g, **f64)
    w = torch.searchsorted(flat, u + z, right=True) - z * vocab
    w = torch.clamp(w, 0, vocab - 1)

    freq = torch.bincount(w, minlength=vocab)
    order = torch.sort(freq, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(vocab, device=device)

    # the seed's order of the documents
    perm = torch.randperm(docs, device=device, generator=torch.Generator(
        device=device).manual_seed(int(seed)))
    starts = torch.cumsum(lens, 0) - lens
    lens = lens[perm]
    d = torch.repeat_interleave(torch.arange(docs, device=device), lens)
    first = torch.cumsum(lens, 0) - lens
    src = starts[perm][d] + torch.arange(d.shape[0], device=device) - first[d]
    return Tokens(rank[w[src]].to(torch.int32), d.to(torch.int32),
                  lens.to(torch.int32), freq[order])
