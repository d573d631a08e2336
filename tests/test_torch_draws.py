"""The MH chain's pre-drawn randoms: the port's ``mh_draws`` entry points
against the JAX package's draws, and a replay of the CUDA kernel's
arithmetic against the plain version.

  * ``ops.mh_draws_train`` on CPU tensors (the plain version) equals
    ``repro.core.lightlda.draw_mh_randoms(key, make_doc_draw(...))``
    bitwise, at a snapshot group's shape with empty and one-token documents
    and padded slots;
  * ``ops.mh_draws_foldin`` equals serving's ``_doc_randoms(fold_in(keys,
    s), z, nd)`` in the chain's [S, B*L] layout, at a fold-in batch's shape;
  * a numpy uint32 replay of what one thread of ``csrc/mh_draws.cu``
    writes -- in the training kernel's split layout the block's tile and
    the thread's half (the three uniforms or the doc proposal) mapped to
    (step, slot), in its whole layout the thread's slot at every step, in
    the fold-in kernel the block's (tile, document, step) and the thread's
    half; the key derivation order included -- equals the plain version at
    a few hundred sampled (block, thread) pairs.  It pins
    the kernel's order on the CPU before any chip time is spent; on the
    card ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel
    itself to the plain version.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import lightlda as jlda
from repro.infer import foldin as jfold
from repro_torch import rng as trng
from repro_torch.core import lightlda as tlda
from repro_torch.kernels import mh_draws as tdraws
from repro_torch.kernels import ops


def _group(k, batch, seed, empty_first=False):
    """A training group's draw inputs: documents of lengths 0, 1 and more,
    tokens padded to a whole number of groups (padded slots name document
    0), and the group at its middle."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 60, 400).astype(np.int32)
    lens[1::7] = 0
    lens[2::7] = 1
    lens[0] = 0 if empty_first else lens[0]
    n = int(lens.sum())
    npad = -(-n // batch) * batch + batch
    d = np.zeros(npad, np.int32)
    d[:n] = np.repeat(np.arange(lens.size, dtype=np.int32), lens)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    z = rng.integers(0, k, npad).astype(np.int32)
    lo = (n // batch) * batch - batch // 2       # straddles the padding
    return d[lo:lo + batch], z, start, lens


def _key(seed):
    return np.asarray(jax.random.PRNGKey(seed), np.uint32)


def _train_plain(k, steps, batch, seed, empty_first=False):
    d_b, z, start, lens = _group(k, batch, seed, empty_first)
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=steps)
    key = torch.from_numpy(_key(seed).astype(np.int64))
    got = ops.mh_draws_train(key, *(torch.from_numpy(x) for x in
                                    (d_b, z, start, lens)), batch, cfg)
    return got, (d_b, z, start, lens), cfg


@pytest.mark.parametrize("k,steps,batch,empty_first", [
    (7, 2, 8192, False), (130, 3, 1000, True), (1000, 2, 8192, True)])
def test_train_draws_equal_jax(k, steps, batch, empty_first):
    got, (d_b, z, start, lens), _ = _train_plain(k, steps, batch, k,
                                                 empty_first)
    jcfg = jlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=steps)
    draw = jlda.make_doc_draw(None, jnp.asarray(d_b), jnp.asarray(z),
                              jnp.asarray(start), jnp.asarray(lens), jcfg)
    want = jlda.draw_mh_randoms(jnp.asarray(_key(k)), draw, batch, jcfg)
    for name, a, g in zip(want._fields, want, got):
        a = np.asarray(a)
        assert g.shape == (steps, batch) and a.dtype == g.numpy().dtype
        np.testing.assert_array_equal(a, g.numpy(), err_msg=name)


def _foldin_inputs(k, b, l, seed):
    rng = np.random.default_rng(seed)
    nd = rng.integers(0, l + 1, b).astype(np.int32)
    nd[:3] = (0, 1, l)
    z = rng.integers(0, k, (b, l)).astype(np.int32)
    return np.arange(100, 100 + b), z, nd


@pytest.mark.parametrize("k,steps,sweep", [(7, 2, 0), (1000, 2, 29),
                                           (130, 3, 5)])
def test_foldin_draws_equal_jax(k, steps, sweep):
    b, l = 32, 1024 if k == 1000 else 96
    seeds, z, nd = _foldin_inputs(k, b, l, k)
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=steps)
    got = ops.mh_draws_foldin(trng.keys_from_seeds(seeds), sweep,
                              torch.from_numpy(z), torch.from_numpy(nd), cfg)
    jcfg = jlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=steps)
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(int(s)), sweep)
                       for s in seeds])
    want = jax.vmap(lambda kk, zr, n: jfold._doc_randoms(kk, zr, n, jcfg))(
        jkeys, jnp.asarray(z), jnp.asarray(nd))       # [B, S, L] each
    for name, a, g in zip(got._fields, want, got):
        a = np.asarray(a).transpose(1, 0, 2).reshape(steps, b * l)
        np.testing.assert_array_equal(a, g.numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# A numpy uint32 replay of one kernel thread.
# ---------------------------------------------------------------------------

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(key, x0, x1):
    """csrc/mh_draws.cu ``threefry``: uint32 scalars, wrapping adds."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    x0, x1 = U32(x0) + ks[0], U32(x1) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << U32(r)) | (x1 >> U32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def _child(key, i):
    return _threefry(key, 0, i)


def _bits(key, n):
    a, b = _threefry(key, int(n) >> 32, int(n) & 0xFFFFFFFF)
    return a ^ b


def _uniform(b):
    return np.array([(b >> U32(9)) | U32(0x3F800000)],
                    np.uint32).view(np.float32)[0] - np.float32(1.0)


def _randint(higher, lower, k, mult):
    return int((higher % U32(k)) * U32(mult) + lower % U32(k)) % k


def _doc_key(ks, j):
    """Thread j of a step's four: k1, split(k2, 2)[0], [1], k3."""
    if j == 0:
        return _child(ks, 0)
    if j == 3:
        return _child(ks, 2)
    return _child(_child(ks, 1), j - 1)


def _doc_draw(keys, c, nd_i, kalpha, k, mult, z_at):
    """The doc proposal at counter ``c`` from the block's four doc keys."""
    nd = np.float32(nd_i)
    pos = min(int(np.int32(_uniform(_bits(keys[0], c)) * max(nd,
                                                              np.float32(1)))),
              max(int(nd) - 1, 0))
    z_unif = _randint(_bits(keys[1], c), _bits(keys[2], c), k, mult)
    use_tok = _uniform(_bits(keys[3], c)) * (nd + np.float32(kalpha)) < nd
    return z_at(pos) if use_tok else z_unif


TILE = 128       # csrc/mh_draws.cu kTile: elements of a tile, two threads each


def _train_thread(block, t, whole, key, batch, steps, d_b, z, start, lens,
                  kalpha, k, mult):
    """What thread ``t`` of block ``block`` writes in its first work item
    of ``mh_draws_train_kernel``: ``{array: [(flat offset, value)]}``,
    empty past the batch.  ``whole``: a thread per slot, every draw at
    every step; else the split layout, item ``block`` a tile of 128 slots
    at one step, threads 0-127 its uniforms and 128-255 its doc proposals.
    The block's keys come first, in its prologue's thread order: [kw, kwa,
    kda], then four a step."""
    shared = [_child(key, j) for j in (0, 1, 3)]
    if whole:
        i, ss, parts = block * 2 * TILE + t, range(steps), (0, 1)
    else:
        per_step = -(-batch // TILE)
        s, half = block // per_step, int(t >= TILE)
        i = (block - s * per_step) * TILE + t - TILE * half
        ss, parts = (s,), (half,)
    if i >= batch:
        return {}
    out = {}
    for s in ss:
        n = s * batch + i
        if 0 in parts:
            for name, kk in zip(("u_word", "u_waccept", "u_daccept"), shared):
                out.setdefault(name, []).append((n, _uniform(_bits(kk, n))))
        if 1 in parts:
            ks = _child(_child(key, 2), s)                 # split(kd, S)[s]
            d = int(d_b[i])
            out.setdefault("z_doc", []).append((n, _doc_draw(
                [_doc_key(ks, j) for j in range(4)], i, int(lens[d]), kalpha,
                k, mult, lambda p: z[start[d] + p])))
    return out


@pytest.mark.parametrize("k,steps,whole", [(7, 2, False), (1000, 3, False),
                                           (130, 2, True)])
def test_train_kernel_replay_equals_plain(k, steps, whole):
    batch = 8192 - 37                        # a ragged last tile
    got, (d_b, z, start, lens), cfg = _train_plain(k, steps, batch, 5, True)
    key = tuple(_key(5))
    kalpha, mult = tdraws.k_alpha(cfg), tdraws.randint_mult(k)
    blocks = -(-batch // (2 * TILE)) if whole else steps * -(-batch // TILE)
    last = batch % (2 * TILE if whole else TILE)
    rng = np.random.default_rng(0)
    picks = [(blocks - 1, t) for t in (0, last - 1, last, 128, 128 + last,
                                       255) if t < 256]
    picks += [(int(a), int(b)) for a, b in
              zip(rng.integers(0, blocks, 150), rng.integers(0, 256, 150))]
    seen = set()
    with np.errstate(over="ignore"):
        for block, t in picks:
            out = _train_thread(block, t, whole, key, batch, steps, d_b, z,
                                start, lens, kalpha, k, mult)
            for name, writes in out.items():
                for n, want in writes:
                    assert getattr(got, name).reshape(-1)[n].item() == want, \
                        (name, block, t)
                seen.add(name)
    assert seen == {"u_word", "u_waccept", "u_daccept", "z_doc"}


def _foldin_thread(block, t, doc, b, l, sweep, nd, z, kalpha, k, mult):
    """What thread ``t`` of block ``(x, row, m)`` writes in
    ``mh_draws_foldin_kernel`` for a [b, l] batch, the document's key
    ``doc``: ``{array: (flat offset, value)}``."""
    tile = TILE
    while tile > 32 and tile // 2 >= l:
        tile //= 2
    x, row, m = block
    sw = _child(doc, sweep)                                # fold_in
    keys = [_child(sw, j) for j in (0, 1, 3)]
    keys += [_doc_key(_child(sw, 2), j) for j in range(4)]
    half = t >= tile
    col = x * tile + t - (tile if half else 0)
    if col >= l:
        return {}
    c, o = m * l + col, (m * b + row) * l + col
    if not half:
        return {name: (o, _uniform(_bits(kk, c))) for name, kk in
                zip(("u_word", "u_waccept", "u_daccept"), keys[:3])}
    return {"z_doc": (o, _doc_draw(keys[3:], c, int(nd[row]), kalpha, k,
                                   mult, lambda p: z[row, p]))}


@pytest.mark.parametrize("k,steps,sweep,l", [(7, 2, 0, 128),
                                             (1000, 2, 29, 200),
                                             (130, 3, 5, 40)])
def test_foldin_kernel_replay_equals_plain(k, steps, sweep, l):
    b = 32
    seeds, z, nd = _foldin_inputs(k, b, l, 3)
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=steps)
    keys = trng.keys_from_seeds(seeds)
    got = ops.mh_draws_foldin(keys, sweep, torch.from_numpy(z),
                              torch.from_numpy(nd), cfg)
    kalpha, mult = tdraws.k_alpha(cfg), tdraws.randint_mult(k)
    tile = TILE
    while tile > 32 and tile // 2 >= l:
        tile //= 2
    rng = np.random.default_rng(1)
    seen = set()
    with np.errstate(over="ignore"):
        for _ in range(160):
            block = (int(rng.integers(0, -(-l // tile))),
                     int(rng.integers(0, b)), int(rng.integers(0, steps)))
            doc = tuple(keys[block[1]].numpy().astype(np.uint32))
            out = _foldin_thread(block, int(rng.integers(0, 2 * tile)), doc,
                                 b, l, sweep, nd, z, kalpha, k, mult)
            for name, (o, want) in out.items():
                assert getattr(got, name).reshape(-1)[o].item() == want, \
                    (name, block)
                seen.add(name)
    assert seen == {"u_word", "u_waccept", "u_daccept", "z_doc"}


def test_kernel_constants_match_the_plain_arithmetic():
    """``randint_mult`` is ``rng.randint``'s multiplier, and ``k_alpha`` the
    float32 value PyTorch adds for ``nd + K * alpha``."""
    for k in (1, 7, 130, 1000, 65537, 100_003):
        m = (2 ** 16) % k
        assert tdraws.randint_mult(k) == ((m * m) & 0xFFFFFFFF) % k
    cfg = tlda.LDAConfig(num_topics=1000, vocab_size=50, alpha=0.1)
    nd = torch.tensor([0.0, 3.0, 257.0])
    assert torch.equal(nd + cfg.K * cfg.alpha,
                       nd + torch.tensor(tdraws.k_alpha(cfg)))


def test_wrappers_refuse_cpu_tensors_and_bad_steps():
    cfg = tlda.LDAConfig(num_topics=7, vocab_size=50)
    i32 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tdraws.mh_draws_train_cuda(torch.zeros(2, dtype=torch.int64), i32,
                                   i32, i32, i32, 4, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        tdraws.mh_draws_foldin_cuda(torch.zeros((1, 2), dtype=torch.int64),
                                    0, i32.view(1, 4), i32[:1], cfg)
    assert "mh_draws_train" in ops.KERNELS and "mh_draws_foldin" in ops.KERNELS
