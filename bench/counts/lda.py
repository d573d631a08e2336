"""The work of one LightLDA sweep, counted from what it has to do.

Every function takes the sweep's shape -- ``tokens`` (valid tokens
resampled, never padded slots), ``vocab``, ``topics``, ``docs`` and
``mh_steps`` -- and returns ``(int32 operations, bytes)``.  Each distinct
input element is counted read once and each output written once, at its
own width, never as a 32-byte sector.  Table entries that a token gathers
(its word's and document's counts at the proposed topics, its alias
bucket) are not counted: how many distinct entries a sweep touches depends
on the draws, so leaving them out keeps every count a lower bound, and no
layout of the same work can read above 100 % of it.
"""
from __future__ import annotations

# int32 operations of one threefry2x32 hash: 20 rounds of add, rotate (one
# funnel shift on the card) and xor
HASH_OPS = 60
# hashes a token draws per MH step: the word draw and its coin, the doc
# proposal's coin, and the doc proposal itself (a position, a topic of two
# words, the choice between them)
HASHES_PER_STEP = 7


def mh_draws(tokens, vocab, topics, docs, mh_steps):
    """The chain's randoms: the hashes; read each token's document id and
    its document's offset and length, write four float32 or int32 values a
    step."""
    ops = HASHES_PER_STEP * mh_steps * HASH_OPS * tokens
    nbytes = 4 * tokens + 8 * min(docs, tokens) + 16 * mh_steps * tokens
    return ops, nbytes


def mh_sample(tokens, vocab, topics, docs, mh_steps):
    """The chain: read each token's word, document, topic and randoms and
    the topic totals, write its new topic."""
    nbytes = 12 * tokens + 16 * mh_steps * tokens + 4 * topics + 4 * tokens
    return 0, nbytes


def alias_build(tokens, vocab, topics, docs, mh_steps):
    """The word-proposal tables of every row: read a float32 weight, write a
    float32 probability and an int32 alias per entry."""
    return 0, 12 * vocab * topics


def delta_push(tokens, vocab, topics, docs, mh_steps):
    """The merge: read each token's row, document, old and new topic and
    whether it changed (the changed tokens' count updates are left out)."""
    return 0, 17 * tokens


def sweep(tokens, vocab, topics, docs, mh_steps):
    """The whole sweep as one piece of work, with nothing that one kernel
    hands to the next: the draws' hashes; read every token's word, document
    and topic, write its topic; read the word-topic counts and write the
    word-proposal tables."""
    ops = HASHES_PER_STEP * mh_steps * HASH_OPS * tokens
    nbytes = 16 * tokens + 8 * min(docs, tokens) + 12 * vocab * topics
    return ops, nbytes
