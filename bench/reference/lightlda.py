"""Plain reference of the pipelined LightLDA sweep, frozen with the benchmark.

Plain PyTorch only: it imports nothing of the program under test and takes
nothing the program made.  From the corpus and the job's numbers it works
out again the random streams (jax's threefry2x32, as the program reproduces
them bitwise), the initial topics, the model-block grouping of the
pipelined executor, the alias tables of every group and the Metropolis-
Hastings chain of every token, in the program's floating-point order.  So a
sound program agrees with it to the bit, and a count of disagreeing tokens
or table entries has the limit 0.

The float arithmetic takes a ``dtype``: float32 is the configuration's
precision; the control runs the same sweep in bfloat16.

Layout assumptions, all of the benchmark's own jobs: one parameter-server
shard (the physical row order of ``n_wk`` is the word order), a model-block
count and staleness as the traffic file gives them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_XLA_WINDOW = 32          # the reduce-window width of the row sums' order
CAP_ROUND = 256           # a group's slot capacity is rounded up to this


# -- threefry2x32, as jax draws it ------------------------------------------

def threefry(k1, k2, x0: torch.Tensor, x1: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 values;
    ``k1``/``k2`` are ints or tensors that broadcast against the counters."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    return (0, int(seed) & MASK)


def split(key: Key, num: int) -> list:
    """``jax.random.split``: key i is threefry(key, (0, i))."""
    out = []
    for i in range(num):
        x0, x1 = threefry(torch.tensor(key[0]), torch.tensor(key[1]),
                          torch.tensor(0), torch.tensor(i))
        out.append((int(x0), int(x1)))
    return out


def bits(key: Key, counters: torch.Tensor) -> torch.Tensor:
    """32 random bits at flat positions ``counters`` (int64, < 2**32) of a
    draw from ``key``."""
    x0, x1 = threefry(key[0], key[1], torch.zeros_like(counters), counters)
    return x0 ^ x1


def uniform(key: Key, counters: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1) in float32 at ``counters``."""
    b = bits(key, counters)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def randint(key: Key, counters: torch.Tensor, span: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, 0, span)`` (int32) at ``counters``."""
    hi_key, lo_key = split(key, 2)
    higher = bits(hi_key, counters)
    lower = bits(lo_key, counters)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((higher % span) * mult) & MASK) + (lower % span)
    return ((off & MASK) % span).to(torch.int32)


def sweep_key(seed: int, sweep: int) -> Key:
    """The key of the job's ``sweep``-th sweep (0-based): the session splits
    ``PRNGKey(seed)`` once before the first sweep and keeps the second half,
    then ``key, sub = split(key)`` before every sweep."""
    key = split(prng_key(seed), 2)[1]
    for _ in range(sweep + 1):
        key, sub = split(key, 2)
    return sub


def init_topics(seed: int, n: int, k: int, device) -> torch.Tensor:
    """The initial topics: ``randint(PRNGKey(seed), (n,), 0, k)``."""
    out = torch.empty(n, dtype=torch.int32, device=device)
    step = 1 << 22
    for lo in range(0, n, step):
        c = torch.arange(lo, min(n, lo + step), dtype=torch.int64,
                         device=device)
        out[lo:lo + c.shape[0]] = randint(prng_key(seed), c, k)
    return out


# -- the model-block grouping of the pipelined executor ---------------------

def blocked_rows(vocab: int, model_blocks: int, staleness: int) -> int:
    """Rows of ``n_wk`` in one group: the block size rounded up until it
    divides the rows, times the staleness rounded down to a divisor of the
    block count, plus one."""
    rpb = -(-vocab // model_blocks)
    while vocab % rpb:
        rpb += 1
    n_blocks = vocab // rpb
    s = max(0, min(int(staleness), n_blocks - 1))
    while s > 0 and n_blocks % (s + 1):
        s -= 1
    return rpb * (s + 1)


class Groups(NamedTuple):
    """Tokens of each group in token order (``tokens[lo[g]:lo[g+1]]``),
    each token's slot in its group's row, and the row's capacity."""
    tokens: torch.Tensor
    slot: torch.Tensor
    lo: list
    cap: int
    rows: int


def groups(w: torch.Tensor, vocab: int, model_blocks: int,
           staleness: int) -> Groups:
    rows = blocked_rows(vocab, model_blocks, staleness)
    n_groups = vocab // rows
    grp = w.long() // rows
    order = torch.sort(grp, stable=True).indices
    counts = torch.bincount(grp, minlength=n_groups)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(w.shape[0], device=w.device) - starts[grp[order]]
    need = max(int(counts.max()), 1)
    cap = -(-need // CAP_ROUND) * CAP_ROUND
    lo = [0] + torch.cumsum(counts, 0).tolist()
    return Groups(order, slot, lo, cap, rows)


# -- counts -----------------------------------------------------------------

def counts(w, d, z, vocab: int, k: int, num_docs: int):
    """(n_wk [V, K], n_k [K], n_dk [D, K]) int32 of assignments ``z``."""
    one = torch.ones_like(z)
    nwk = torch.zeros(vocab * k, dtype=torch.int32, device=z.device)
    nwk.index_add_(0, w.long() * k + z.long(), one)
    nk = torch.bincount(z.long(), minlength=k).to(torch.int32)
    ndk = torch.zeros(num_docs * k, dtype=torch.int32, device=z.device)
    ndk.index_add_(0, d.long() * k + z.long(), one)
    return nwk.view(vocab, k), nk, ndk.view(num_docs, k)


# -- Vose alias tables ------------------------------------------------------

def _sum_left_to_right(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def row_sum(p: torch.Tensor) -> torch.Tensor:
    """Row sums in windows of 32 columns (zero padding split before and
    after), window sums again in windows, each window left to right: the
    order the program's tables are built in."""
    while p.shape[1] > _XLA_WINDOW:
        pad = (-p.shape[1]) % _XLA_WINDOW
        p = torch.nn.functional.pad(p, (pad // 2, pad - pad // 2))
        p = _sum_left_to_right(p.reshape(p.shape[0], -1, _XLA_WINDOW))
    return _sum_left_to_right(p)


def _col(mat, idx):
    return mat.gather(1, idx[:, None])[:, 0]


def _set_col(mat, idx, val):
    mat.scatter_(1, idx[:, None], val[:, None].to(mat.dtype))


def alias_tables(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vose's two-stack construction for every row of ``p`` [R, K]: each
    step retires the top small entry of every row against its top large
    one.  Returns (prob [R, K] in p's dtype, alias [R, K] int32)."""
    v, k = p.shape
    dev = p.device
    psum = torch.clamp_min(row_sum(p)[:, None], 1e-30)
    q = p * (psum.new_tensor(float(k)) / psum)
    is_small = q < 1.0
    idx = torch.arange(k, dtype=torch.int64, device=dev).expand(v, k)
    small_pos = torch.cumsum(is_small, 1) - 1
    large_pos = torch.cumsum(~is_small, 1) - 1
    small = torch.zeros((v, k + 1), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(is_small, small_pos, k), idx)[:, :k].contiguous()
    large = torch.zeros((v, k + 1), dtype=torch.int64, device=dev).scatter_(
        1, torch.where(~is_small, large_pos, k), idx)[:, :k].contiguous()
    n_small = is_small.sum(-1)
    n_large = k - n_small
    prob = torch.ones((v, k), dtype=p.dtype, device=dev)
    alias = idx.clone()
    for _ in range(2 * k):
        active = (n_small > 0) & (n_large > 0)
        if not bool(active.any()):
            break
        s = _col(small, torch.clamp_min(n_small - 1, 0))
        l = _col(large, torch.clamp_min(n_large - 1, 0))
        q_s = _col(q, s)
        q_l = _col(q, l)
        _set_col(prob, s, torch.where(active, q_s, _col(prob, s)))
        _set_col(alias, s, torch.where(active, l, _col(alias, s)))
        q_l_new = q_l + q_s - 1.0
        _set_col(q, l, torch.where(active, q_l_new, q_l))
        n_small_after = torch.where(active, n_small - 1, n_small)
        demote = active & (q_l_new < 1.0)
        n_large = torch.where(demote, n_large - 1, n_large)
        slot = torch.clamp_max(n_small_after, k - 1)
        _set_col(small, slot, torch.where(demote, l, _col(small, slot)))
        n_small = torch.where(demote, n_small_after + 1, n_small_after)
    return torch.clamp(prob, 0.0, 1.0), alias.to(torch.int32)


# -- one pipelined sweep ----------------------------------------------------

class Model(NamedTuple):
    vocab: int
    topics: int
    alpha: float
    beta: float
    mh_steps: int


class Docs(NamedTuple):
    """The corpus as the reference reads it: tokens in document order."""
    w: torch.Tensor
    d: torch.Tensor
    doc_start: torch.Tensor
    doc_len: torch.Tensor


def docs_of(w: torch.Tensor, d: torch.Tensor, num_docs: int) -> Docs:
    doc_len = torch.bincount(d.long(), minlength=num_docs).to(torch.int32)
    doc_start = (torch.cumsum(doc_len, 0) - doc_len).to(torch.int32)
    return Docs(w, d, doc_start, doc_len)


def _draws(key: Key, slot: torch.Tensor, cap: int, doc: torch.Tensor,
           docs: Docs, z: torch.Tensor, m: Model):
    """The chain's randoms of the tokens at ``slot`` of a group row of
    ``cap`` slots: per step the word draw, its coin, the doc proposal and
    its coin."""
    kw, kwa, kd, kda = split(key, 4)
    nd = docs.doc_len[doc].to(torch.float32)
    starts = docs.doc_start[doc]
    out = []
    for s, kds in enumerate(split(kd, m.mh_steps)):
        flat = slot + s * cap
        k1, k2, k3 = split(kds, 3)
        pos = (uniform(k1, slot) * torch.clamp_min(nd, 1.0)).to(torch.int32)
        pos = torch.minimum(pos, torch.clamp_min(nd.to(torch.int32) - 1, 0))
        z_tok = z[(starts + pos).long()]
        z_unif = randint(k2, slot, m.topics)
        use_tok = uniform(k3, slot) * (nd + m.topics * m.alpha) < nd
        out.append((uniform(kw, flat), uniform(kwa, flat),
                    torch.where(use_tok, z_tok, z_unif), uniform(kda, flat)))
    return out


def _chain(draws, z0, w, d, row, nwk, ndk, nk, prob, alias, m: Model, dtype):
    """The MH chain of tokens ``(w, d)`` from topics ``z0`` against the
    group-start counts, word proposals from the group's alias tables at
    row ``row`` of the group."""
    k = m.topics
    vbeta = m.vocab * m.beta
    wl, dl, rl = w.long(), d.long(), row.long()
    nkf = nk.to(dtype)

    def p(t):
        tl = t.long()
        excl = (t == z0).to(dtype)
        a = ndk[dl, tl].to(dtype) - excl
        b = nwk[wl, tl].to(dtype) - excl
        c = nkf[tl] - excl
        return (a + m.alpha) * (b + m.beta) / (c + vbeta)

    def qw(t):
        tl = t.long()
        return (nwk[wl, tl].to(dtype) + m.beta) / (nkf[tl] + vbeta)

    def qd(t):
        return ndk[dl, t.long()].to(dtype) + m.alpha

    z = z0
    for u_word, u_wacc, z_doc, u_dacc in draws:
        scaled = u_word * k
        bucket = torch.clamp_max(scaled.to(torch.int32), k - 1)
        coin = scaled - bucket
        bl = bucket.long()
        z_prop = torch.where(coin < prob[rl, bl].to(torch.float32), bucket,
                             alias[rl, bl])
        ratio = (p(z_prop) * qw(z)) / (
            torch.clamp_min(p(z), 1e-30) * torch.clamp_min(qw(z_prop), 1e-30))
        z = torch.where(u_wacc.to(dtype) < ratio, z_prop, z)
        ratio = (p(z_doc) * qd(z)) / (
            torch.clamp_min(p(z), 1e-30) * torch.clamp_min(qd(z_doc), 1e-30))
        z = torch.where(u_dacc.to(dtype) < ratio, z_doc, z)
    return z


def sweep(z: torch.Tensor, docs: Docs, grp: Groups, key: Key, m: Model,
          dtype=torch.float32, chunk: int = 1 << 23) -> torch.Tensor:
    """One pipelined sweep from topics ``z`` with the sweep's ``key``:
    group by group, alias tables of the group's rows from the group-start
    counts, every token of the group resampled against them, the group's
    changes merged before the next group.  Returns the new topics."""
    z = z.clone()
    nwk, nk, ndk = counts(docs.w, docs.d, z, m.vocab, m.topics,
                          docs.doc_len.shape[0])
    n_groups = len(grp.lo) - 1
    keys = split(key, n_groups)
    for g in range(n_groups):
        lo, hi = grp.lo[g], grp.lo[g + 1]
        if hi == lo:
            continue
        first = g * grp.rows
        weights = (nwk[first:first + grp.rows].to(dtype) + m.beta) / (
            nk.to(dtype)[None, :] + m.vocab * m.beta)
        prob, alias = alias_tables(weights)
        tok = grp.tokens[lo:hi]
        z_new = torch.empty(hi - lo, dtype=torch.int32, device=z.device)
        for c in range(0, hi - lo, chunk):
            t = tok[c:c + chunk]
            w, d = docs.w[t], docs.d[t]
            draws = _draws(keys[g], grp.slot[lo + c:lo + c + t.shape[0]],
                           grp.cap, d, docs, z, m)
            z_new[c:c + t.shape[0]] = _chain(draws, z[t], w, d, w - first,
                                             nwk, ndk, nk, prob, alias, m,
                                             dtype)
        z0 = z[tok]
        moved = z_new != z0
        t, zo, zn = tok[moved], z0[moved].long(), z_new[moved].long()
        w, d = docs.w[t].long(), docs.d[t].long()
        one = torch.ones_like(zo, dtype=torch.int32)
        k = m.topics
        nwk.view(-1).index_add_(0, w * k + zo, -one).index_add_(
            0, w * k + zn, one)
        ndk.view(-1).index_add_(0, d * k + zo, -one).index_add_(
            0, d * k + zn, one)
        nk.index_add_(0, zo, -one).index_add_(0, zn, one)
        z[tok] = z_new
    return z

