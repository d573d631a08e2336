"""The plain reference against ``repro_torch``'s plain CPU path at a tiny
size: the random streams, the initial topics and whole pipelined sweeps
agree to the bit."""
from __future__ import annotations

import pytest
import torch

from bench_cases import tiny_cell
from bench.drivers import train
from bench.reference import lightlda as ref
from bench.traffic import corpus
from repro_torch import rng as jrng
from repro_torch.api import Session


def test_threefry_streams_equal_the_program():
    key = jrng.PRNGKey(2**31 + 99)
    mine = ref.prng_key(2**31 + 99)
    assert [tuple(k.tolist()) for k in jrng.split(key, 4)] == ref.split(
        mine, 4)
    c = torch.arange(1000, dtype=torch.int64)
    assert torch.equal(jrng.uniform(key, 1000), ref.uniform(mine, c))
    assert torch.equal(jrng.randint(key, 1000, 0, 97),
                       ref.randint(mine, c, 97))


@pytest.mark.parametrize("vocab,blocks", [(400, 16), (450, 16), (300, 4)])
def test_sweeps_equal_the_program(vocab, blocks):
    cell = tiny_cell(vocab=vocab, model_blocks=blocks)
    seed = 5 + vocab
    m = train.model_of(cell["config"])
    tokens = corpus.make_corpus(cell["traffic"]["corpus"], vocab, seed,
                                torch.device("cpu"))
    n = tokens.w.shape[0]
    session = Session(train.job_of(cell["config"], cell["traffic"], tokens,
                                 seed), log_fn=lambda msg: None,
                      device="cpu")
    state, _, _ = session.make_step()
    z = ref.init_topics(seed, n, m.topics, "cpu")
    assert torch.equal(z, state.z[:n])
    docs = ref.docs_of(tokens.w, tokens.d, tokens.doc_len.shape[0])
    grp = ref.groups(tokens.w, vocab, blocks, 1)
    for i in range(3):
        state = session.run().state
        z = ref.sweep(z, docs, grp, ref.sweep_key(seed, i), m)
        assert torch.equal(z, state.z[:n]), i
    nwk, nk, ndk = ref.counts(tokens.w, tokens.d, z, vocab, m.topics,
                              tokens.doc_len.shape[0])
    assert torch.equal(nwk, state.nwk.to_dense())
    assert torch.equal(nk, state.nk.value)
    assert torch.equal(ndk, state.ndk)


def test_alias_tables_draw_their_weights():
    g = torch.Generator().manual_seed(0)
    p = torch.rand(5, 37, generator=g) ** 4
    prob, alias = ref.alias_tables(p)
    pmf = (prob / 37).scatter_add(1, alias.long(), (1 - prob) / 37)
    assert torch.allclose(pmf, p / p.sum(1, keepdim=True), atol=1e-6)
