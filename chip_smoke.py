#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and network-PS paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

  1. device   -- require CUDA; print the card's name and power limit;
  2. build    -- nvcc every kernel of the paths from src/repro_torch/kernels/
                 csrc, one process per source, all at once;
  3. kernels  -- each kernel against its plain PyTorch version on the card:
                 mh_sample bitwise at K in {7, 130, 1000} in both modes, at
                 32,768, 8,192 and 100 tokens; alias_build bitwise in prob
                 and alias at K in {7, 130, 1000, 2000}, rows with exact-1.0
                 entries and near-one-hot rows included;
                 delta_push and delta_apply_coo bitwise at (rows, K) in
                 {(300, 7), (2048, 130), (2000, 1000), (100000, 1000)},
                 with out-of-range rows, padding and Zipf-skewed rows;
                 delta_push's merge form (n_wk, n_dk and n_k in one launch)
                 bitwise at (R, D, K) in {(300, 50, 7), (2048, 400, 130),
                 (100000, 8000, 1000), (12500, 8000, 1000)} and 8,192 and
                 1,809,664 tokens, none, half and all changed, rows and
                 docs past their tables; mh_draws (the MH chain's
                 randoms in one launch) bitwise in all four arrays: the
                 training entry point at K in {7, 130, 1000} and a snapshot
                 group's, a pipelined group's, a tiered block's and a stream
                 visit's slots, with empty and one-token documents and
                 padded slots; the fold-in entry point at serving's
                 [32 x 1024] batch, sweeps 0 and 29;
  4. serving  -- the serving slice at full width, V = 100,000 and
                 K = 1,000: TopicModel -> snapshot -> transform of 512
                 documents -> score -> a ConcurrentEngine under 8 client
                 threads; launch counters (mh_sample and mh_draws_foldin
                 30 times a batch), θ sums, batch independence, and
                 a TopicModel built on the CPU from the same counts: its
                 alias tables and its θ of 8 documents equal the card's
                 bitwise;
  5. training -- the training slice at the same widths:
                 APSLDA(LDAJob(..., route=HybridRoute(hot_words=2000))).fit()
                 on a 2M-token synthetic corpus, 3 sweeps of the snapshot
                 executor, then one sweep of the pipelined executor (16
                 model blocks, staleness 1; the z update's device ms from
                 its obs metrics); launch counters (one mh_draws_train,
                 mh_sample and delta_push per group in both executors --
                 the draws and the whole merge -- and no delta_apply_coo;
                 alias_build once per snapshot sweep and once per
                 pipelined group),
                 exact count conservation, falling perplexity, and the
                 trained model serving 64 held-out documents; then a small
                 job on the card and on the CPU, both executors, with z and
                 every count table equal bitwise;
  6. push     -- the message path: the trained n_wk handle pushes one
                 snapshot group through MatrixHandle.push with
                 HybridRoute(2000), launching delta_push's dense form and
                 delta_apply_coo once each; its table equals the one-launch
                 merge's bitwise;
  7. stream   -- the out-of-core trainer at the same widths on the
                 training corpus written in 8 shards of 262,144 tokens
                 (HybridRoute(2000)): 2 epochs of the snapshot executor
                 (exact conservation against the z files' histogram after
                 each epoch, the corpus perplexity falling), the same job
                 stopped after 11 shard visits with a checkpoint and
                 resumed to the end of epoch 2 on a second copy of the
                 stream (counts and every z file equal bitwise), 1 epoch
                 of the blocked executor (16 model blocks, staleness 1);
                 launch counters on each run, and per shard visit the
                 median ms of the host-side parts (obs spans); then a
                 small streamed job on the card and on the CPU, both
                 modes, counts and z files equal bitwise;
  8. service  -- TopicService at the same widths: train_async (2 sweeps,
                 a publish after each) while 8 client threads x 16
                 requests submit through start_serving; every request
                 served or shed, a swap under load, θ sums to 1;
  9. launch   -- repro_torch.launch.topic_serve --selftest and a small
                 repro_torch.launch.lda stream run with checkpoints, then
                 its --resume, in this process on the card;
 10. tiered   -- tiered storage at the same widths on the training corpus:
                 APSLDA(LDAJob(storage="tiered", model_blocks=64,
                 hot_rows=8192, tier_refresh=1, sweeps=3)), then the same
                 job auto-sized and auto-resized (hot_rows=None); exact
                 conservation of the composed table, falling perplexity,
                 launches (one mh_draws_train, mh_sample, alias_build and
                 delta_push per non-empty block a sweep, no
                 delta_apply_coo), the tier's
                 traffic and the device-table gauge (at most 1/8 of the
                 400 MB table), one more sweep under the profiler (its
                 split by part); then a small tiered job on the card and on
                 the CPU (z, counts and cold-store files equal bitwise) and
                 one snapshot group through a tiered handle with
                 HybridRoute(2000) (one delta_push, one delta_apply_coo;
                 the composed table equal to the dense handle's push);
 11. autotune -- APSLDA(LDAJob(route="auto", staleness="auto",
                 model_blocks=16, sweeps=2)): the measured route and
                 staleness tables and the choice, one mh_draws_train per
                 mh_sample; n_wk and n_k equal a fit with the chosen route
                 and staleness bitwise;
 12. net      -- the network parameter server on the training corpus in
                 stream_train's shards, stream_train's snapshot job: one
                 worker process for 2 epochs (n_wk, n_k and every z file
                 equal the stream plane's bitwise), two workers (exact
                 conservation against the z files' histogram, falling
                 perplexity, each worker's own launch counters: one
                 mh_draws_train, mh_sample and delta_push a group and one
                 alias_build a visit); tokens/s, the per-visit split and
                 the server's commit ms; repro_torch.launch.net_smoke
                 --device cuda --workers 2 (faults, a SIGKILL) exits 0; a
                 1-worker job at V = 3,000, K = 64 on the card and on the
                 CPU, counts and z files equal bitwise;
 13. report   -- per-kernel times at the main paths' shapes (alias_build
                 held bitwise at serving's φ and at each executor's
                 weights; the merge at each executor's group, also by
                 destination; mh_draws at a snapshot group, a pipelined
                 group, a tiered block and a fold-in batch), the whole
                 merge of one group as the
                 executors composed it before (route plan, token_deltas,
                 adds) against the one-launch merge, in turns, then one
                 pipelined sweep taken each way; a
                 profile of one fold-in batch and of one training sweep,
                 the tensor operations of the key derivations that stay
                 eager, one JSON line with each kernel's launches, error,
                 times and bound, then the device line last.

Imports nothing of JAX or of the JAX package.  Writes profiles to
chiprun_out/serving_profile.txt and chiprun_out/training_profile.txt, the
training run's trace and metrics to chiprun_out/train_obs/, the streamed
runs' to chiprun_out/stream_obs/, the service's to
chiprun_out/service_obs/ and the tiered runs' to chiprun_out/tiered_obs/;
one tiered sweep runs under the profiler (tiered_profile.txt).  Stream
directories, checkpoints and cold stores go to temporary directories,
removed at exit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SECTOR = 32                    # bytes moved by one scattered 4-byte read

V_FULL, K_FULL = 100_000, 1_000
N_DOCS, N_QUERIES, N_CLIENTS, PER_CLIENT = 512, 8, 8, 16
TRAIN_DOCS, TRAIN_DOC_LEN, TRAIN_TOPICS, HOT_WORDS = 8000, 250, 100, 2000
DELTA_SHAPES = ((300, 7), (2048, 130), (2000, 1000), (100_000, 1000))
DELTA_TOKENS = 32 * 1024
# delta_push's merge form: (rows, docs, K) and token counts per group; the
# in-memory executors' groups at 8,000 docs, a stream visit's at the
# stream's doc cap of 32,768 (a snapshot group of 8,192 tokens and a
# blocked group of 237,568 slots)
MERGE_CASES = (((300, 50, 7), (8192, 1_809_664)),
               ((2048, 400, 130), (8192, 1_809_664)),
               ((100_000, 8000, 1000), (8192, 1_809_664)),
               ((12_500, 8000, 1000), (8192, 1_809_664)),
               ((100_000, 32_768, 1000), (8192,)),
               ((12_500, 32_768, 1000), (237_568,)))
PIPE_BLOCKS, PIPE_STALENESS = 16, 1
REF_CHUNK = 1 << 18        # tokens per call of mh_sample's plain version
# mh_draws: the card's int32 rate (132 SMs x 64 int32 lanes per clock at the
# 1,980 MHz boost clock; data sheet and Hopper white paper), and the int32
# operations of one threefry2x32 hash: 20 rounds of add, rotate and xor (the
# key injections fold into three-input adds, IADD3)
INT32_OPS = 132 * 64 * 1.98e9
HASH_OPS = 20 * 3
# training draws: (slots, documents) of a snapshot group, a pipelined group,
# a tiered block, and a stream visit's snapshot and blocked groups
DRAW_CASES = ((8192, 8000), (1_809_664, 8000), (2_097_152, 8000),
              (8192, 32_768), (237_568, 32_768))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device ms per launch with CUDA events.

    With no ``before``, ``reps`` launches run back to back in one span, each
    finding the L2 as the one before left it, and the span is divided by
    ``reps``.  With ``before``, each launch has its own span, ``before`` runs
    ahead of it outside the span (``evict`` reads a 128 MB buffer, which
    leaves the L2 cold and clean), and the median span is returned.

    A sleep kernel holds the stream while the host enqueues all of it, so
    the spans hold the device's work and none of the wrapper's host time.
    With ``device_only`` an event after the sleep shows whether it outlasted
    the enqueue; where it did not, the sleep is doubled and the run made
    again.  A plain version that waits on the host by design (alias_build's
    loop reads a flag each step) is timed with ``device_only=False``: its
    spans keep that waiting.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(128 * 2 ** 20, dtype=torch.uint8,
                                device="cuda")
        self.sleep_cycles = 1 << 20

    def evict(self) -> None:
        self.flush.sum()

    def ms(self, fn, reps: int, device_only: bool = True,
           before=None) -> float:
        torch = self.torch
        event = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
        fn()                                               # warm up
        torch.cuda.synchronize()
        while True:
            torch.cuda._sleep(self.sleep_cycles)
            held = torch.cuda.Event()
            held.record()
            spans = []
            for _ in range(reps if before else 1):
                if before:
                    before()
                start, end = event(), event()
                start.record()
                for _ in range(1 if before else reps):
                    fn()
                end.record()
                spans.append((start, end))
            if not (device_only and held.query()):
                break
            torch.cuda.synchronize()            # the device caught up
            self.sleep_cycles *= 2
            if self.sleep_cycles > 1 << 34:
                raise RuntimeError("the host cannot enqueue the launches "
                                   "within a sleep of 2^34 cycles (or they "
                                   "outnumber the device's launch queue)")
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in spans]
        return float(np.median(times)) if before else times[0] / reps


# -- model and documents ----------------------------------------------------

def make_counts(v: int, k: int, seed: int, tokens: float = 1e8):
    """Word-topic counts of a trained-looking model: a Zipf word marginal
    over ``tokens`` tokens, each word with 80% of its count in its own
    topic (so each topic is concentrated on its own words) and the rest
    spread over four random topics."""
    rng = np.random.default_rng(seed)
    freq = 1.0 / np.arange(1, v + 1) ** 1.05
    count = np.maximum(np.floor(freq / freq.sum() * tokens), 5).astype(np.int64)
    rows = np.arange(v)
    home = rng.integers(0, k, v)
    own = (count * 4) // 5
    nwk = np.zeros((v, k), np.int32)
    nwk[rows, home] = own
    rest = count - own
    for j in range(4):
        share = rest // 4 + (rest % 4 if j == 0 else 0)
        np.add.at(nwk, (rows, rng.integers(0, k, v)), share.astype(np.int32))
    return nwk, nwk.sum(0, dtype=np.int64).astype(np.int32)


def make_docs(nwk: np.ndarray, n: int, seed: int, lo: int = 16,
              hi: int = 1024):
    """Documents drawn from the model's own topics (1-3 topics each), with
    lengths log-uniform over [lo, hi]."""
    rng = np.random.default_rng(seed + 1)
    v, k = nwk.shape
    cdf = {}
    docs = []
    for _ in range(n):
        length = int(math.exp(rng.uniform(math.log(lo), math.log(hi))))
        topics = rng.choice(k, size=rng.integers(1, 4), replace=False)
        pick = rng.choice(topics, size=length)
        doc = np.empty(length, np.int32)
        for t in topics:
            if t not in cdf:
                c = np.cumsum(nwk[:, t].astype(np.float64))
                cdf[t] = c / c[-1]
            m = pick == t
            doc[m] = np.minimum(np.searchsorted(cdf[t], rng.random(m.sum())),
                                v - 1)
        docs.append(doc)
    return docs


# -- phase 3: kernels against their plain versions ----------------------------

def random_mh_inputs(torch, lda, rows: int, k: int, t: int, docs: int,
                     seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cu = dict(device="cuda")
    nwk = torch.randint(0, 50, (rows, k), generator=g, **cu).float()
    nk = nwk.sum(0) + 7.0
    from repro_torch.core.alias import build_alias_rows
    table = build_alias_rows((nwk + 0.01) / (nk + rows * 0.01))
    w = torch.randint(0, rows, (t,), generator=g, dtype=torch.int32, **cu)
    d = torch.randint(0, docs, (t,), generator=g, dtype=torch.int32, **cu)
    z0 = torch.randint(0, k, (t,), generator=g, dtype=torch.int32, **cu)
    ndk = torch.randint(0, 4, (docs, k), generator=g, dtype=torch.int32, **cu)
    ndk.index_put_((d.long(), z0.long()),
                   torch.ones_like(z0), accumulate=True)
    s = 2
    rng = lda.MHRandoms(
        torch.rand((s, t), generator=g, **cu),
        torch.rand((s, t), generator=g, **cu),
        torch.randint(0, k, (s, t), generator=g, dtype=torch.int32, **cu),
        torch.rand((s, t), generator=g, **cu))
    return rng, z0, w, d, nwk, ndk, nk, table.prob, table.alias


def alias_test_weights(torch, rows: int, k: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    wts = torch.rand((rows, k), generator=g, device="cuda") ** 2 + 1e-5
    wts[0] = 1.0                                   # every q exactly 1
    wts[1] = 1.0                                   # q == 1 entries beside
    wts[1, 0], wts[1, 1 % k] = 0.5, 1.5            # one small, one large
    wts[2] = 1e-6                                  # near one-hot
    wts[2, k // 3] = 1e3
    wts[3] = 0.0                                   # all-zero row
    wts[4, :] = 1e-6
    wts[4, 0] = 1.0
    return wts


def alias_bitwise(torch, got, want, what: str) -> float:
    """Raise unless two alias tables are equal bitwise; return the largest
    prob difference (0.0)."""
    equal = bool(torch.equal(got.prob, want.prob)
                 and torch.equal(got.alias, want.alias))
    if not equal:
        raise AssertionError(
            f"alias_build differs from its plain version at {what}: prob max "
            f"{float((got.prob - want.prob).abs().max())}, "
            f"{int((got.alias != want.alias).sum())} alias entries")
    return float((got.prob - want.prob).abs().max())


def check_kernels(torch) -> None:
    from repro_torch.core import lightlda as lda
    from repro_torch.kernels import alias_build, mh_sample, ref

    for k in (7, 130, 1000):
        for tokens in (32 * 1024, 8192, 100):
            for frozen in (True, False):
                args = random_mh_inputs(torch, lda, rows=2048, k=k, t=tokens,
                                        docs=32, seed=k + tokens)
                cfg = lda.LDAConfig(num_topics=k, vocab_size=2048)
                got = mh_sample.mh_sample_cuda(*args, cfg, frozen=frozen)
                want = ref.mh_sample_ref(*args, cfg, frozen=frozen)
                torch.cuda.synchronize()
                match = bool(torch.equal(got, want))
                moved = float((got != args[1]).float().mean())
                log(json.dumps({"check": "mh_sample", "K": k,
                                "frozen": frozen, "tokens": tokens,
                                "match": match,
                                "moved_frac": round(moved, 4)}))
                if not match:
                    raise AssertionError(
                        f"mh_sample differs from its plain version at K={k},"
                        f" {tokens} tokens, frozen={frozen}")

    for k in (7, 130, 1000, 2000):
        wts = alias_test_weights(torch, rows=511, k=k, seed=k)
        got = alias_build.alias_build_cuda(wts)
        want = ref.alias_build_ref(wts)
        torch.cuda.synchronize()
        alias_bitwise(torch, got, want, f"K={k}")
        warps, rows_per_sm = alias_build.launch_config(k)
        log(json.dumps({"check": "alias_build", "K": k, "rows": 511,
                        "bitwise": True, "warps_per_block": warps,
                        "rows_per_sm": rows_per_sm}))


def delta_inputs(torch, rows: int, k: int, t: int, seed: int,
                 changed_frac: float):
    """A token batch for delta_push: Zipf-skewed rows (thousands of tokens
    on row 0), 1 % of the rows past ``rows`` (half of those changed),
    ``changed`` at the given fraction."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cu = dict(device="cuda")
    u = torch.rand((t,), generator=g, **cu)
    zipf = torch.floor(torch.exp(u * math.log(rows))).to(torch.int64) - 1
    r = torch.clamp(zipf, 0, rows - 1).to(torch.int32)
    out_of_range = torch.rand((t,), generator=g, **cu) < 0.01
    r = torch.where(out_of_range, rows + (torch.arange(t, **cu) % 7), r)
    z_old = torch.randint(0, k, (t,), generator=g, dtype=torch.int32, **cu)
    z_new = torch.randint(0, k, (t,), generator=g, dtype=torch.int32, **cu)
    changed = torch.rand((t,), generator=g, **cu) < changed_frac
    return r.to(torch.int32), z_old, z_new, changed


def coo_inputs(torch, rows: int, k: int, m: int, seed: int):
    """A COO buffer for delta_apply_coo: value-0 padding (a quarter),
    repeated coordinates, Zipf-skewed rows, 1 % out-of-range rows and 1 %
    out-of-range columns, values in [-3, 3]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cu = dict(device="cuda")
    u = torch.rand((m,), generator=g, **cu)
    r = torch.clamp(torch.floor(torch.exp(u * math.log(rows))).to(
        torch.int64) - 1, 0, rows - 1)
    c = torch.randint(0, k, (m,), generator=g, **cu)
    r[m // 2: m // 2 + m // 8] = r[: m // 8]          # repeated coordinates
    c[m // 2: m // 2 + m // 8] = c[: m // 8]
    bad_r = torch.rand((m,), generator=g, **cu) < 0.01
    bad_c = torch.rand((m,), generator=g, **cu) < 0.01
    r = torch.where(bad_r, rows + torch.arange(m, **cu) % 5, r)
    c = torch.where(bad_c, torch.where(torch.arange(m, **cu) % 2 == 0,
                                       k + 1, -1), c)
    v = torch.randint(-3, 4, (m,), generator=g, **cu)
    v[torch.rand((m,), generator=g, **cu) < 0.25] = 0  # padding
    return r.to(torch.int32), c.to(torch.int32), v.to(torch.int32)


def check_delta_kernels(torch) -> None:
    from repro_torch.kernels import delta_push, ref

    for i, (rows, k) in enumerate(DELTA_SHAPES):
        for frac in (0.0, 0.5, 1.0):
            args = delta_inputs(torch, rows, k, DELTA_TOKENS, 17 + i, frac)
            out = torch.zeros((rows, k), dtype=torch.int32, device="cuda")
            got = delta_push.delta_push_cuda(*args, out)
            want = ref.delta_push_ref(*args, rows, k)
            torch.cuda.synchronize()
            match = bool(torch.equal(got, want))
            log(json.dumps({"check": "delta_push", "rows": rows, "K": k,
                            "tokens": DELTA_TOKENS, "changed_frac": frac,
                            "nonzero": int((want != 0).sum()),
                            "match": match}))
            if not match:
                raise AssertionError(f"delta_push differs from its plain "
                                     f"version at {(rows, k)}, changed "
                                     f"{frac}")
        args = coo_inputs(torch, rows, k, 2 * DELTA_TOKENS, 29 + i)
        base = torch.randint(0, 9, (rows, k), dtype=torch.int32,
                             device="cuda")
        got = delta_push.delta_apply_coo_cuda(*args, base.clone())
        want = ref.delta_apply_coo_ref(*args, rows, k, out=base.clone())
        torch.cuda.synchronize()
        match = bool(torch.equal(got, want))
        log(json.dumps({"check": "delta_apply_coo", "rows": rows, "K": k,
                        "entries": 2 * DELTA_TOKENS, "match": match}))
        if not match:
            raise AssertionError(f"delta_apply_coo differs from its plain "
                                 f"version at {(rows, k)}")
    check_merge(torch)


def draw_inputs(torch, k: int, slots: int, docs: int, seed: int):
    """A training group's draw inputs on the card: ``docs`` documents, one
    in seven empty and one in seven of one token, the rest around the
    mean length that fills ``slots``; tokens padded past the end (padded
    slots name document 0, which is empty); the group's slots straddle the
    last tokens and the padding."""
    rng = np.random.default_rng(seed)
    mean = max(2, 2 * slots // docs)
    lens = rng.integers(0, 2 * mean, docs).astype(np.int32)
    lens[::7], lens[1::7] = 0, 1
    n = int(lens.sum())
    lo = max(n - slots // 2, 0)
    total = lo + slots
    d = np.zeros(max(total, n), np.int32)
    d[:n] = np.repeat(np.arange(docs, dtype=np.int32), lens)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    z = rng.integers(0, k, d.size).astype(np.int32)
    key = torch.tensor([int(rng.integers(0, 2 ** 32)),
                        int(rng.integers(0, 2 ** 32))], dtype=torch.int64)
    dev = lambda x: torch.from_numpy(x).to("cuda")  # noqa: E731
    return (key.to("cuda"), dev(d[lo:lo + slots]), dev(z), dev(start),
            dev(lens), slots)


def draws_match(torch, got, want) -> bool:
    return all(bool(torch.equal(a, b)) for a, b in zip(got, want))


def check_draws(torch) -> None:
    """mh_draws against its plain version on the card: the training entry
    point at K in {7, 130, 1000} and each of DRAW_CASES' group shapes; the
    fold-in entry point at serving's [32 x 1024] batch for sweeps 0 and
    29.  Bitwise in all four arrays."""
    from repro_torch import rng as jrng
    from repro_torch.core.lightlda import LDAConfig
    from repro_torch.kernels import mh_draws, ref

    for k in (7, 130, 1000):
        cfg = LDAConfig(num_topics=k, vocab_size=100)
        for i, (slots, docs) in enumerate(DRAW_CASES):
            args = draw_inputs(torch, k, slots, docs, seed=31 * k + i)
            got = mh_draws.mh_draws_train_cuda(*args, cfg)
            want = ref.mh_draws_train_ref(*args, cfg)
            match = draws_match(torch, got, want)
            log(json.dumps({"check": "mh_draws_train", "K": k,
                            "slots": slots, "docs": docs, "match": match}))
            if not match:
                raise AssertionError(f"mh_draws_train differs from its plain "
                                     f"version at K={k}, {slots} slots")
            del args, got, want
        rng = np.random.default_rng(k)
        b, l = 32, 1024
        nd = rng.integers(0, l + 1, b).astype(np.int32)
        nd[:3] = (0, 1, l)
        z = torch.from_numpy(rng.integers(0, k, (b, l)).astype(np.int32)
                             ).to("cuda")
        nd = torch.from_numpy(nd).to("cuda")
        keys = jrng.keys_from_seeds(range(1000, 1000 + b), "cuda")
        for sweep in (0, 29):
            got = mh_draws.mh_draws_foldin_cuda(keys, sweep, z, nd, cfg)
            want = ref.mh_draws_foldin_ref(keys, sweep, z, nd, cfg)
            match = draws_match(torch, got, want)
            log(json.dumps({"check": "mh_draws_foldin", "K": k,
                            "batch": [b, l], "sweep": sweep,
                            "match": match}))
            if not match:
                raise AssertionError(f"mh_draws_foldin differs from its "
                                     f"plain version at K={k}, sweep {sweep}")


def merge_inputs(torch, rows: int, docs: int, k: int, t: int, seed: int,
                 changed_frac: float):
    """A group's reassignments for delta_push's merge form: the batch of
    ``delta_inputs`` plus doc ids in runs, as a group's tokens come
    (document order), 1 % of them past ``docs``."""
    r, z_old, z_new, changed = delta_inputs(torch, rows, k, t, seed,
                                            changed_frac)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cu = dict(device="cuda")
    d = torch.sort(torch.randint(0, docs, (t,), generator=g, **cu)).values
    past = torch.rand((t,), generator=g, **cu) < 0.01
    d = torch.where(past, docs + torch.arange(t, **cu) % 5, d)
    return r, z_old, z_new, changed, d.to(torch.int32)


def merge_ref(torch, batch, tables):
    """delta_push's plain merge of ``batch`` into ``tables`` [out, ndk,
    nk] in place."""
    from repro_torch.kernels import ref

    r, zo, zn, changed, d = batch
    out, ndk, nk = tables
    ref.delta_push_ref(r, zo, zn, changed, out.shape[0], out.shape[1],
                       out=out, docs=d, ndk_out=ndk, nk_out=nk)


def merge_cuda(torch, batch, tables):
    from repro_torch.kernels import delta_push

    r, zo, zn, changed, d = batch
    out, ndk, nk = tables
    delta_push.delta_push_cuda(r, zo, zn, changed, out, docs=d, ndk_out=ndk,
                               nk_out=nk)


def check_merge(torch) -> None:
    """delta_push's merge form against its plain version, bitwise in all
    three tables: at MERGE_CASES' shapes and token counts, none, half and
    all changed."""
    for i, ((rows, docs, k), tokens) in enumerate(MERGE_CASES):
        g = torch.Generator(device="cuda").manual_seed(53 + i)
        base = [torch.randint(0, 9, shape, generator=g, dtype=torch.int32,
                              device="cuda")
                for shape in ((rows, k), (docs, k), (k,))]
        for t in tokens:
            for frac in (0.0, 0.5, 1.0):
                batch = merge_inputs(torch, rows, docs, k, t, 41 + i, frac)
                want = [x.clone() for x in base]
                merge_ref(torch, batch, want)
                got = [x.clone() for x in base]
                merge_cuda(torch, batch, got)
                torch.cuda.synchronize()
                match = all(torch.equal(a, b) for a, b in zip(got, want))
                log(json.dumps({"check": "delta_push_merge", "rows": rows,
                                "docs": docs, "K": k, "tokens": t,
                                "changed_frac": frac, "match": match}))
                if not match:
                    raise AssertionError(
                        f"delta_push's merge differs from its plain version "
                        f"at {(rows, docs, k)}, {t} tokens, changed {frac}")
                del got, want, batch
        del base


# -- phase 4: the serving slice ----------------------------------------------

def serve_slice(torch, seed: int, card: str, device: str = "cuda",
                v: int = V_FULL, k: int = K_FULL, n_docs: int = N_DOCS):
    """Run the serving path at (v, k) and check it; returns a dict of
    results (the main-path launch counts among them)."""
    from repro_torch.api import TopicModel
    from repro_torch.core.lightlda import LDAConfig
    from repro_torch.infer import ConcurrentEngine, EngineConfig
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    nwk, nk = make_counts(v, k, seed)
    docs = make_docs(nwk, n_docs + N_QUERIES, seed)
    docs, queries = docs[:n_docs], [q[:8] for q in docs[n_docs:]]
    seeds = [1000 + i for i in range(n_docs)]
    log(f"[serve] model V={v} K={k} tokens={int(nk.sum())}, {n_docs} docs "
        f"({sum(map(len, docs))} tokens) made in "
        f"{time.perf_counter() - t0:.2f} s")

    cfg = LDAConfig(num_topics=k, vocab_size=v)
    ecfg = EngineConfig()
    out = {}
    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    model = TopicModel(nwk, nk, cfg, ecfg=ecfg, device=device)
    sync = (lambda: torch.cuda.synchronize()) if device == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    snap = model.snapshot
    sync()
    out["publish_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    model.publisher()                      # a second publish, allocator warm
    sync()
    out["republish_ms"] = (time.perf_counter() - t0) * 1e3
    publish_counts = ops.launch_counts()

    t0 = time.perf_counter()
    theta = model.transform(docs, seeds)
    out["transform_s"] = time.perf_counter() - t0
    transform_counts = ops.launch_counts()
    scores = model.score(queries, docs[:64], seeds[:64])

    eng = model.engine()
    lat, results = [], {}
    lock = threading.Lock()
    with ConcurrentEngine(eng) as ceng:
        def client(c):
            for j in range(PER_CLIENT):
                i = (c * PER_CLIENT + j) % n_docs
                ts = time.perf_counter()
                r = ceng.submit(docs[i], seed=seeds[i]).result(timeout=600)
                dt = (time.perf_counter() - ts) * 1e3
                with lock:
                    lat.append(dt)
                    results[i] = r.theta
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        tc = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        out["concurrent_s"] = time.perf_counter() - tc
        if any(th.is_alive() for th in threads):
            raise AssertionError("a serving client did not finish")
    out["counts"] = ops.launch_counts()
    # ---------------------------------------------------- end of main path

    buckets = {}
    for d in docs:
        b = eng.bucket_of(len(d))
        buckets[b] = buckets.get(b, 0) + 1
    batches = sum(-(-n // ecfg.max_batch) for n in buckets.values())
    b1 = transform_counts["mh_sample"] - publish_counts["mh_sample"]
    draws = (transform_counts["mh_draws_foldin"]
             - publish_counts["mh_draws_foldin"])
    out["batches"] = batches
    if device == "cuda":
        if publish_counts["alias_build"] != 2:
            raise AssertionError("each publish must launch alias_build once")
        for name, n in (("mh_sample", b1), ("mh_draws_foldin", draws)):
            if n != ecfg.foldin.num_sweeps * batches:
                raise AssertionError(f"{name} launched {n} times in "
                                     f"transform, expected sweeps x batches "
                                     f"= {ecfg.foldin.num_sweeps * batches}")
        if transform_counts["mh_draws_train"]:
            raise AssertionError("serving launched the training draws")
    sums = theta.sum(1)
    if not (np.abs(sums - 1.0) <= 1e-3).all():
        raise AssertionError(f"θ rows do not sum to 1: {sums.min()} "
                             f"{sums.max()}")
    if not (np.isfinite(scores).all() and scores.shape == (N_QUERIES, 64)):
        raise AssertionError("scores are not finite [Q, 64]")
    for i, th in results.items():
        if not np.array_equal(th, theta[i]):
            raise AssertionError(f"concurrent θ of doc {i} differs from the "
                                 f"synchronous engine's")
    # one request alone == the same request inside a full batch
    full = max(buckets, key=lambda b: buckets[b])
    i = next(j for j, d in enumerate(docs) if eng.bucket_of(len(d)) == full)
    alone = eng.infer([docs[i]], [seeds[i]])[0].theta
    if not np.array_equal(alone, theta[i]):
        raise AssertionError("θ of a request alone differs from its θ in a "
                             "full batch")
    # card against CPU: a TopicModel built on the CPU from the same counts
    # (its alias tables by the plain construction), the same seeds
    if device == "cuda":
        t0 = time.perf_counter()
        cpu_model = TopicModel(nwk, nk, cfg, ecfg=EngineConfig(max_batch=1),
                               device="cpu")
        cpu_snap = cpu_model.snapshot
        out["cpu_publish_s"] = time.perf_counter() - t0
        for name in ("aprob", "aalias"):
            if not torch.equal(getattr(snap.model, name).cpu(),
                               getattr(cpu_snap.model, name)):
                raise AssertionError(f"the card's alias tables ({name}) "
                                     f"differ from the CPU's")
        idx = list(range(8))
        cpu_theta = cpu_model.transform([docs[j] for j in idx],
                                        [seeds[j] for j in idx])
        if not np.array_equal(cpu_theta, theta[idx]):
            raise AssertionError("card θ differs from CPU-plain θ: max "
                                 f"{np.abs(cpu_theta - theta[idx]).max()}")
        del cpu_model, cpu_snap
    out["docs_per_s"] = n_docs / out["transform_s"]
    out["p50_ms"] = float(np.percentile(lat, 50))
    out["p90_ms"] = float(np.percentile(lat, 90))
    out["p99_ms"] = float(np.percentile(lat, 99))
    out["requests"] = len(lat)
    log(json.dumps({"serve": {
        "V": v, "K": k, "docs": n_docs, "batches": batches,
        "publish_ms": out["publish_ms"], "republish_ms": out["republish_ms"],
        "transform_s": out["transform_s"],
        "docs_per_s": out["docs_per_s"], "concurrent_requests": len(lat),
        "concurrent_s": out["concurrent_s"], "request_p50_ms": out["p50_ms"],
        "request_p90_ms": out["p90_ms"], "request_p99_ms": out["p99_ms"],
        "launches": out["counts"], "cpu_publish_s": out.get("cpu_publish_s"),
        "checks": "ok", "card": card}}))
    out.update(model=model, docs=docs, seeds=seeds)
    return out


# -- phase 5: the training slice ---------------------------------------------

def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def conservation(torch, st, what: str) -> None:
    """Exact count conservation of a trained state: every count table is
    the histogram of the assignments."""
    k = st.ndk.shape[1]
    nwk = st.nwk.to_dense().long()
    nk, ndk = st.nk.value.long(), st.ndk.long()
    tokens = int(st.valid.sum())
    w, z = st.w.long()[st.valid], st.z.long()[st.valid]
    hist = torch.zeros(nwk.numel(), dtype=torch.long, device=nwk.device)
    hist.index_add_(0, w * k + z, torch.ones_like(w))
    checks = {
        "nwk_sum": int(nwk.sum()) == tokens,
        "nk_sum": int(nk.sum()) == tokens,
        "nwk_cols_eq_nk": bool(torch.equal(nwk.sum(0), nk)),
        "ndk_rows_eq_doc_len": bool(torch.equal(ndk.sum(1),
                                                st.doc_len.long())),
        "nwk_eq_histogram": bool(torch.equal(hist.view_as(nwk), nwk)),
    }
    if not all(checks.values()):
        raise AssertionError(f"{what}: counts not conserved: {checks}")


def sweep_spans(trace_path: Path) -> list:
    """(sweep ms, dispatch ms) per sweep from the obs trace of a fit."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    sweeps = [e for e in events if e.get("name") == "exec.sweep"]
    disp = [e for e in events if e.get("name") == "exec.dispatch"]
    return [(a["dur"] / 1e3, b["dur"] / 1e3) for a, b in zip(sweeps, disp)]


def groups_per_sweep(info: dict) -> int:
    return info["n_blocks"] // info["group"]


def expected_launches(groups: int, alias_builds: int) -> dict:
    """Launches of the path's kernels for ``groups`` groups: mh_draws_train
    (the group's randoms) and mh_sample once per group; delta_push once per
    group, the whole merge on one process, whatever the route; no
    delta_apply_coo and no fold-in draws; alias_build ``alias_builds``
    times (once per snapshot sweep, once per pipelined group)."""
    return {"mh_sample": groups, "delta_push": groups, "delta_apply_coo": 0,
            "alias_build": alias_builds, "mh_draws_train": groups,
            "mh_draws_foldin": 0}


def train_slice(torch, seed: int, card: str, device: str = "cuda",
                v: int = V_FULL, k: int = K_FULL,
                n_docs: int = TRAIN_DOCS) -> dict:
    """Train at (v, k) through APSLDA: the snapshot executor for 3 sweeps,
    then the pipelined executor for one; check each and serve the model.
    Launch counts are checked on the card only (the CPU runs the plain
    versions)."""
    from repro_torch.api import APSLDA, HybridRoute, LDAJob, ObsConfig
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    corp = synthetic_corpus(n_docs, v, true_topics=TRAIN_TOPICS,
                            mean_doc_len=TRAIN_DOC_LEN, seed=seed)
    log(f"[train] corpus V={v} {corp.num_docs} docs {corp.num_tokens} "
        f"tokens, hot words {HOT_WORDS} hold "
        f"{corp.word_freq[:HOT_WORDS].sum() / corp.num_tokens:.3f} of them, "
        f"made in {time.perf_counter() - t0:.2f} s")
    obs_dir = ROOT / "chiprun_out" / "train_obs"
    job = LDAJob(corpus=corp, num_topics=k, vocab_size=v,
                 route=HybridRoute(hot_words=HOT_WORDS), sweeps=3,
                 eval_every=1, seed=seed,
                 obs=ObsConfig(enabled=True, out_dir=str(obs_dir)))
    out = {"corpus": corp}

    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    est = APSLDA(job, log_fn=log, device=device)
    model = est.fit()
    sync(torch, device)
    counts = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    info = est.result_.info
    want = expected_launches(groups_per_sweep(info) * job.sweeps,
                             alias_builds=job.sweeps)
    for name, n in want.items():
        if device == "cuda" and counts[name] != n:
            raise AssertionError(f"snapshot executor: {name} launched "
                                 f"{counts[name]} times, expected {n}")
    conservation(torch, est.result_.state, "snapshot executor")
    ppl = [row["perplexity"] for row in model.history]
    if not (len(ppl) == 3 and ppl[2] < ppl[0]):
        raise AssertionError(f"perplexity did not fall: {ppl}")
    spans = sweep_spans(obs_dir / "trace.json")
    tokens = corp.num_tokens
    out.update(model=model, state=est.result_.state, cfg=model.cfg,
               snapshot_counts=counts, info=info)
    log(json.dumps({"train": {
        "executor": "snapshot", "V": v, "K": k, "tokens": tokens,
        "docs": corp.num_docs, "route": info["route"],
        "groups_per_sweep": groups_per_sweep(info), "sweeps": job.sweeps,
        "sweep_ms": [a for a, _ in spans],
        "dispatch_ms": [b for _, b in spans],
        "tokens_per_s": [tokens / (a / 1e3) for a, _ in spans],
        "perplexity": ppl, "launches": counts, "checks": "ok",
        "card": card}}))

    pobs = obs_dir / "pipelined"
    pjob = dataclasses.replace(job, model_blocks=PIPE_BLOCKS,
                               staleness=PIPE_STALENESS, sweeps=1,
                               obs=ObsConfig(enabled=True,
                                             out_dir=str(pobs)))
    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    pest = APSLDA(pjob, log_fn=log, device=device)
    pmodel = pest.fit()
    sync(torch, device)
    pcounts = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    pinfo = pest.result_.info
    want = expected_launches(groups_per_sweep(pinfo),
                             alias_builds=groups_per_sweep(pinfo))
    for name, n in want.items():
        if device == "cuda" and pcounts[name] != n:
            raise AssertionError(f"pipelined executor: {name} launched "
                                 f"{pcounts[name]} times, expected {n}")
    conservation(torch, pest.result_.state, "pipelined executor")
    row = pmodel.history[0]
    (sweep_ms, dispatch_ms), = sweep_spans(pobs / "trace.json")
    out["pipelined_counts"] = pcounts
    log(json.dumps({"train": {
        "executor": "pipelined", "model_blocks": pinfo["n_blocks"],
        "rows_per_block": pinfo["rows_per_block"],
        "staleness": pinfo["staleness"], "token_cap": pinfo["token_cap"],
        "groups": groups_per_sweep(pinfo), "sweep_ms": sweep_ms,
        "dispatch_ms": dispatch_ms, "tokens_per_s": tokens / (sweep_ms / 1e3),
        "perplexity": row["perplexity"], "launches": pcounts,
        "z_update_ms": z_update_ms(read_obs(pobs)[1]), "checks": "ok",
        "card": card}}))
    del pest, pmodel

    # the trained model serves: 64 documents drawn from its own topics
    docs = make_docs(model.nwk, 64, seed + 5)
    theta = model.transform(docs, [2000 + i for i in range(64)])
    sums = theta.sum(1)
    if not (theta.shape == (64, k) and np.isfinite(theta).all()
            and (np.abs(sums - 1.0) <= 1e-3).all()):
        raise AssertionError(f"trained model's θ rows do not sum to 1: "
                             f"{sums.min()} {sums.max()}")
    log(json.dumps({"train": {"serve_after_training": {
        "docs": 64, "theta_sum_min": float(sums.min()),
        "theta_sum_max": float(sums.max())}}}))
    return out


def card_vs_cpu(torch, seed: int) -> None:
    """A small job on the card and on the CPU, both executors: z and every
    count table equal bitwise."""
    from repro_torch.api import APSLDA, HybridRoute, LDAJob
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(300, 3000, true_topics=16, seed=seed)
    for extra in ({}, {"model_blocks": 4, "staleness": 1}):
        job = LDAJob(corpus=corp, num_topics=64, vocab_size=3000,
                     route=HybridRoute(hot_words=200), sweeps=2,
                     eval_every=0, seed=seed, **extra)
        states = {}
        for dev in ("cuda", "cpu"):
            est = APSLDA(job, log_fn=lambda m: None, device=dev)
            est.fit()
            st = est.result_.state
            states[dev] = {"z": st.z, "nwk": st.nwk.to_dense(),
                           "nk": st.nk.value, "ndk": st.ndk}
        equal = {name: bool(torch.equal(states["cuda"][name].cpu(),
                                        states["cpu"][name]))
                 for name in states["cpu"]}
        mode = "pipelined" if extra else "snapshot"
        log(json.dumps({"check": "train_card_vs_cpu", "executor": mode,
                        "tokens": corp.num_tokens, "V": 3000, "K": 64,
                        "equal": equal}))
        if not all(equal.values()):
            raise AssertionError(f"{mode} training on the card differs from "
                                 f"the CPU: {equal}")


# -- phases 7-9: the streamed trainer, the serving facade, the launchers ----

STREAM_SHARD_TOKENS = 262_144       # 32 groups of 8,192 tokens a shard
STREAM_STOP = 11                    # the stopped run's shard visits


def read_obs(out_dir: Path):
    """(trace events, metrics by name) of an obs session saved in
    ``out_dir``."""
    from repro_torch.obs import load_jsonl

    events = json.loads((out_dir / "trace.json").read_text())["traceEvents"]
    return events, {r["name"]: r for r in load_jsonl(
        str(out_dir / "metrics.jsonl"))}


def span_ms(events, name: str) -> list:
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e.get("name") == name]


def median(xs) -> float:
    return float(np.median(xs)) if xs else float("nan")


class EpochCheck:
    """A callback that, at the end of every epoch, times the epoch, checks
    exact conservation (``nwk`` sums to the tokens, and the histogram of
    the shards' z files equals ``nwk`` and ``nk``) and takes the training
    perplexity of the whole corpus (every shard's n_dk from its z file).
    The checks' own time is left out of the next epoch's."""

    def __init__(self, torch, reader, cfg):
        self.torch, self.reader, self.cfg = torch, reader, cfg
        self.k = cfg.K
        self.epoch_s: list = []
        self.perplexity: list = []
        self.t0 = None

    def corpus_perplexity(self, view) -> float:
        from repro_torch.core import perplexity as ppl

        torch, cfg = self.torch, self.cfg
        dense = view.nwk.to_dense()
        phi = ppl.phi_from_counts(dense.to(torch.float32),
                                  view.nk.value.to(torch.float32), cfg.beta)
        ll, n_all = 0.0, 0
        for sid in range(self.reader.num_shards):
            sh = self.reader.shard(sid)
            n = sh.n_tokens
            w, d, z = (torch.from_numpy(np.array(x[:n])).to(dense.device)
                       .long() for x in (sh.w, sh.d, sh.z))
            ndk = torch.zeros(sh.doc_len.shape[0] * self.k,
                              dtype=torch.float32, device=dense.device)
            ndk.index_add_(0, d * self.k + z, torch.ones_like(ndk[:n]))
            theta = ppl.theta_from_counts(ndk.view(-1, self.k), cfg.alpha)
            ll += float(ppl.log_likelihood(
                w, d, torch.ones_like(w, dtype=torch.bool), theta, phi))
            n_all += n
        return math.exp(-ll / n_all)

    def on_fit_start(self, info):
        self.t0 = time.perf_counter()

    def on_sweep_end(self, view):
        from repro_torch.data.stream import rebuild_counts_from_stream

        if view.step % self.reader.num_shards:
            return
        view.sync()
        self.epoch_s.append(time.perf_counter() - self.t0)
        tokens = self.reader.meta.num_tokens
        nwk = view.nwk.to_dense().cpu().numpy()
        nk = view.nk.value.cpu().numpy()
        hist_nwk, hist_nk = rebuild_counts_from_stream(self.reader, self.k)
        checks = {"nwk_sum": int(nwk.sum(dtype=np.int64)) == tokens,
                  "nk_sum": int(nk.sum(dtype=np.int64)) == tokens,
                  "nwk_eq_z_histogram": bool((hist_nwk == nwk).all()),
                  "nk_eq_z_histogram": bool((hist_nk == nk).all())}
        if not all(checks.values()):
            raise AssertionError(f"stream epoch {len(self.epoch_s)}: counts "
                                 f"not conserved: {checks}")
        self.perplexity.append(self.corpus_perplexity(view))
        self.t0 = time.perf_counter()

    def on_fit_end(self, view):
        pass


def stream_job(path: str, k: int, v: int, seed: int, epochs: int,
               obs_dir: Optional[Path] = None, block_tokens: int = 8192,
               **kw):
    from repro_torch.api import HybridRoute, LDAJob, ObsConfig

    obs = (ObsConfig(enabled=True, out_dir=str(obs_dir)) if obs_dir
           else ObsConfig())
    return LDAJob(stream_dir=path, num_topics=k, vocab_size=v,
                  route=HybridRoute(hot_words=HOT_WORDS), epochs=epochs,
                  seed=seed, obs=obs, block_tokens=block_tokens, **kw)


def stream_launches(reader, visits: int, info: dict, block_tokens: int
                    ) -> dict:
    """The stream path's launches for ``visits`` shard visits: one
    mh_sample and one delta_push a group; alias_build once a visit in
    snapshot mode, once a group in blocked mode; no delta_apply_coo."""
    if info["mode"] == "blocked":
        groups = visits * (info["n_blocks"] // info["group"])
        return expected_launches(groups, alias_builds=groups)
    groups = visits * (reader.meta.tokens_per_shard // block_tokens
                       // (info["staleness"] + 1))
    return expected_launches(groups, alias_builds=visits)


def check_launches(counts: dict, want: dict, what: str, device: str) -> None:
    if device == "cuda" and counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def visit_split(events) -> dict:
    """Median ms per shard visit of each host-side part."""
    return {"shard_wait": median(span_ms(events, "stream.shard_wait")),
            "index": median(span_ms(events, "stream.index")),
            "h2d": median(span_ms(events, "stream.h2d")),
            "ndk_rebuild": median(span_ms(events, "stream.ndk")),
            "sweep": median(span_ms(events, "exec.sweep")),
            "write_z": median(span_ms(events, "stream.write_z"))}


def prefetch(metrics: dict) -> dict:
    return {name: metrics.get(f"stream.prefetch_{name}", {}).get("value", 0)
            for name in ("hit", "miss", "skip")}


def z_update_replica_ms(torch, reader, job, layout) -> dict:
    """Device ms of a replica of the blocked step's z update, a cross-check
    of the time the training run records (``z_update_ms``): the
    same ``write_valid_z`` on the same index tensors (shard 0's groups),
    writing each group's valid slots alone, one call a group after one
    warm-up call."""
    from repro_torch.train import async_exec

    cfg = job.lda_config(reader.meta.vocab_size)
    _, build_index, _ = async_exec.make_stream_executor(
        cfg, job.exec_config(), layout)
    sh = reader.shard(0)
    idx, bval = build_index(sh.w, np.arange(sh.w.shape[0]) < sh.n_tokens)
    counts = bval.sum(1).tolist()
    idx = idx.cuda().long()
    z = torch.from_numpy(np.array(sh.z)).cuda()
    cap = idx.shape[1]
    new = z[idx[0]].clone()
    async_exec.write_valid_z(z, idx[0], new, cap, counts[:1])     # warm up
    ms = []
    for g in range(idx.shape[0]):
        new = z[idx[g]].clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        async_exec.write_valid_z(z, idx[g], new, cap, counts[g:g + 1])
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return {"per_group_ms": ms, "per_visit_ms": sum(ms),
            "slots_per_group": int(cap), "valid_per_group": counts}


def stream_visit_state(torch, reader, cfg, seed: int):
    """The state of a stream run's first shard visit on the card, built as
    ``_StreamPlane`` builds it: ``init_stream``'s counts and z files, the
    visit's shard moved over, its n_dk [doc_cap, K] histogrammed from z."""
    from repro_torch.api.session import init_stream
    from repro_torch.core import lightlda as lda
    from repro_torch.data import stream

    nwk, nk = init_stream(reader, cfg, seed, device="cuda")
    loader = stream.StreamingLoader(reader, seed=seed, prefetch=False)
    (_, sid), = loader.schedule(stream.Cursor(0, 0), 1)[:1]
    sh = reader.shard(sid)
    n, meta = sh.n_tokens, reader.meta
    w, d, z, doc_start, doc_len = (torch.from_numpy(np.array(x)).cuda()
                                   for x in (sh.w, sh.d, sh.z, sh.doc_start,
                                             sh.doc_len))
    ndk = torch.zeros(meta.doc_cap * cfg.K, dtype=torch.int32,
                      device="cuda").index_add_(
        0, d[:n].long() * cfg.K + z[:n].long(),
        torch.ones(n, dtype=torch.int32, device="cuda"))
    valid = torch.arange(meta.tokens_per_shard, device="cuda") < n
    st = lda.SamplerState(w, d, z, valid, doc_start, doc_len, nwk, nk,
                          ndk.view(meta.doc_cap, cfg.K))
    return st, sh


def check_stream_groups(torch, reader, jobs: dict, seed: int,
                        card: str) -> None:
    """mh_sample (training mode) and delta_push's merge form against their
    plain versions, bitwise, on the inputs of a stream visit's first group
    in each mode (``jobs``: mode -> LDAJob): the [V, K] snapshot or the
    blocked group's pulled rows, n_dk at the stream's doc cap, the blocked
    group's slots from the stream's own token index.  The merge takes the
    group's real reassignments."""
    from repro_torch.kernels import mh_sample
    from repro_torch.train import async_exec

    cfg = jobs["snapshot"].lda_config(reader.meta.vocab_size)
    st, sh = stream_visit_state(torch, reader, cfg, seed)
    train = {"state": st, "cfg": cfg}
    for mode, job in jobs.items():
        if mode == "snapshot":
            args, valid = snapshot_group_inputs(torch, train)
        else:
            _, build_index, _ = async_exec.make_stream_executor(
                cfg, job.exec_config(), st.nwk.layout)
            n = sh.n_tokens
            index = build_index(sh.w, np.arange(sh.w.shape[0]) < n)
            args, valid, _ = pipelined_group_inputs(
                torch, train, tuple(x.numpy() for x in index))
        got = mh_sample.mh_sample_cuda(*args, cfg, frozen=False)
        want = mh_sample_ref_chunked(torch, args, cfg, frozen=False)
        z0 = args[1]
        z_new = torch.where(valid, got, z0)
        batch = (args[2], z0, z_new, (z_new != z0) & valid, args[3])
        tables = group_tables(torch, train, "snapshot" if mode == "snapshot"
                              else "pipelined")
        want_t = [x.clone() for x in tables]
        merge_ref(torch, batch, want_t)
        merge_cuda(torch, batch, tables)
        torch.cuda.synchronize()
        match = {"mh_sample": bool(torch.equal(got, want)),
                 "delta_push_merge": all(torch.equal(a, b)
                                         for a, b in zip(tables, want_t))}
        log(json.dumps({"check": "stream_group", "mode": mode,
                        "table_rows": args[4].shape[0],
                        "ndk_rows": args[5].shape[0], "K": cfg.K,
                        "slots": int(z0.shape[0]),
                        "valid": int(valid.sum()),
                        "changed": int(batch[3].sum()), "match": match,
                        "card": card}))
        if not all(match.values()):
            raise AssertionError(f"stream {mode} group: a kernel differs "
                                 f"from its plain version: {match}")
        del args, got, want, tables, want_t, batch


def stream_train(torch, seed: int, card: str, corp, device: str = "cuda",
                 v: int = V_FULL, k: int = K_FULL,
                 tokens_per_shard: int = STREAM_SHARD_TOKENS,
                 stop: int = STREAM_STOP, block_tokens: int = 8192) -> dict:
    """The out-of-core trainer at (v, k) on ``corp`` written in shards of
    ``tokens_per_shard``: (a) 2 epochs of the snapshot executor, exact
    conservation after each, perplexity falling; (b) the same job on a
    second copy of the stream, stopped after ``stop`` shard visits with a
    checkpoint and resumed to the end of epoch 2: counts and every z file
    equal (a)'s bitwise; (c) 1 epoch of the blocked executor (16 model
    blocks, staleness 1), conserving."""
    import tempfile

    from repro_torch.api import APSLDA, CheckpointPolicy
    from repro_torch.data import stream
    from repro_torch.kernels import ops
    from repro_torch.train import checkpoint as ckpt

    out = {}
    obs_root = ROOT / "chiprun_out" / "stream_obs"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dirs = [str(Path(tmp) / name) for name in ("a", "b")]
        metas = [stream.write_sharded(p, corp, tokens_per_shard)
                 for p in dirs]
        meta = metas[0]
        log(f"[stream] {meta.num_tokens} tokens in {meta.num_shards} shards "
            f"of {tokens_per_shard} (doc cap {meta.doc_cap}), two copies "
            f"written in {time.perf_counter() - t0:.2f} s")
        readers = [stream.ShardedCorpusReader(p) for p in dirs]
        n_shards = meta.num_shards
        if device == "cuda":
            check_stream_groups(
                torch, readers[0],
                {"snapshot": stream_job(dirs[0], k, v, seed, 2,
                                        block_tokens=block_tokens),
                 "blocked": stream_job(dirs[0], k, v, seed, 1,
                                       block_tokens=block_tokens,
                                       model_blocks=PIPE_BLOCKS,
                                       staleness=PIPE_STALENESS)},
                seed, card)

        # (a) two epochs, snapshot executor
        job = stream_job(dirs[0], k, v, seed, 2, obs_root / "snapshot",
                         block_tokens, eval_every=n_shards)
        check = EpochCheck(torch, readers[0], job.lda_config(v))
        ops.reset_launch_counts()
        # ------------------------------------------------------- main path
        est = APSLDA(job, log_fn=log, device=device)
        model = est.fit([check])
        sync(torch, device)
        counts = ops.launch_counts()
        # ----------------------------------------------- end of main path
        info = est.result_.info
        check_launches(counts, stream_launches(readers[0], 2 * n_shards,
                                               info, job.block_tokens),
                       "stream snapshot mode", device)
        ppl = check.perplexity
        if not (len(ppl) == 2 and ppl[1] < ppl[0]):
            raise AssertionError(f"stream perplexity did not fall: {ppl}")
        events, metrics = read_obs(obs_root / "snapshot")
        out["snapshot"] = {
            "epochs": 2, "tokens_per_s": [meta.num_tokens / s
                                          for s in check.epoch_s],
            "epoch_s": check.epoch_s, "corpus_perplexity": ppl,
            "last_shard_perplexity": [row["perplexity"]
                                      for row in model.history],
            "visit_ms": visit_split(events), "prefetch": prefetch(metrics),
            "launches": counts}
        log(json.dumps({"stream_train": dict(out["snapshot"],
                                             mode="snapshot", card=card)}))
        final = {"nwk": est.result_.nwk.value, "nk": est.result_.nk.value}
        del est, model

        # (b) stopped after `stop` visits with a checkpoint, then resumed
        ck = str(Path(tmp) / "ck.npz")
        first = stream_job(dirs[1], k, v, seed, 2, obs_root / "stopped",
                           block_tokens, max_shards=stop, eval_every=0,
                           checkpoint=CheckpointPolicy(path=ck))
        ops.reset_launch_counts()
        # ------------------------------------------------------- main path
        APSLDA(first, log_fn=log, device=device).fit()
        sync(torch, device)
        stopped_counts = ops.launch_counts()
        # ----------------------------------------------- end of main path
        t0 = time.perf_counter()
        saved = ckpt.restore_stream(ck)
        restore_ms = (time.perf_counter() - t0) * 1e3
        if (saved.cursor.epoch, saved.cursor.pos) != divmod(stop, n_shards):
            raise AssertionError(f"checkpoint cursor {saved.cursor}")
        events, _ = read_obs(obs_root / "stopped")
        save_ms = span_ms(events, "stream.save")
        resumed = stream_job(dirs[1], k, v, seed, 2, obs_root / "resumed",
                             block_tokens, eval_every=0,
                             checkpoint=CheckpointPolicy(path=ck,
                                                         resume=True))
        ops.reset_launch_counts()
        # ------------------------------------------------------- main path
        est = APSLDA(resumed, log_fn=log, device=device)
        est.fit()
        sync(torch, device)
        resumed_counts = ops.launch_counts()
        # ----------------------------------------------- end of main path
        check_launches(stopped_counts,
                       stream_launches(readers[1], stop, info,
                                       job.block_tokens),
                       "stopped stream run", device)
        check_launches(resumed_counts,
                       stream_launches(readers[1], 2 * n_shards - stop, info,
                                       job.block_tokens),
                       "resumed stream run", device)
        events, _ = read_obs(obs_root / "resumed")
        equal = {"nwk": bool(torch.equal(est.result_.nwk.value,
                                         final["nwk"])),
                 "nk": bool(torch.equal(est.result_.nk.value, final["nk"])),
                 "z_files": all(np.array_equal(readers[0].read_z(s),
                                               readers[1].read_z(s))
                                for s in range(n_shards))}
        if not all(equal.values()):
            raise AssertionError(f"stop-and-resume differs from the "
                                 f"uninterrupted run: {equal}")
        # the 2-epoch snapshot run's result, which the net phase's one
        # worker must reproduce
        out["snapshot_final"] = {
            "nwk": final["nwk"].cpu().numpy(),
            "nk": final["nk"].cpu().numpy(),
            "z": [readers[1].read_z(s) for s in range(n_shards)]}
        out["resume"] = {"stop_after": stop, "equal": equal,
                         "save_stream_ms": save_ms + span_ms(events,
                                                             "stream.save"),
                         "restore_stream_ms": restore_ms,
                         "resumed_setup_ms": span_ms(events,
                                                     "session.setup"),
                         "checkpoint_bytes": Path(ck).stat().st_size}
        log(json.dumps({"stream_resume": dict(out["resume"], card=card)}))
        del est, final

        # (c) one epoch, blocked executor
        job = stream_job(dirs[0], k, v, seed, 1, obs_root / "blocked",
                         block_tokens, eval_every=n_shards,
                         model_blocks=PIPE_BLOCKS,
                         staleness=PIPE_STALENESS)
        check = EpochCheck(torch, readers[0], job.lda_config(v))
        ops.reset_launch_counts()
        # ------------------------------------------------------- main path
        est = APSLDA(job, log_fn=log, device=device)
        est.fit([check])
        sync(torch, device)
        counts = ops.launch_counts()
        # ----------------------------------------------- end of main path
        binfo = est.result_.info
        check_launches(counts, stream_launches(readers[0], n_shards, binfo,
                                               job.block_tokens),
                       "stream blocked mode", device)
        events, metrics = read_obs(obs_root / "blocked")
        z_replica = (z_update_replica_ms(torch, readers[0], job,
                                         est.result_.nwk.layout)
                     if device == "cuda" else None)
        out["blocked"] = {
            "epochs": 1, "model_blocks": binfo["n_blocks"],
            "rows_per_step": binfo["rows_per_step"],
            "staleness": binfo["staleness"],
            "tokens_per_s": [meta.num_tokens / s for s in check.epoch_s],
            "epoch_s": check.epoch_s, "corpus_perplexity": check.perplexity,
            "visit_ms": visit_split(events),
            "z_update_ms": z_update_ms(metrics),
            "z_update_replica": z_replica,
            "prefetch": prefetch(metrics), "launches": counts}
        log(json.dumps({"stream_train": dict(out["blocked"], mode="blocked",
                                             card=card)}))
        del est
    return out


def stream_card_vs_cpu(torch, seed: int, card: str) -> None:
    """A small streamed job (V = 3,000, K = 64, 300 docs, 4 shards), 2
    epochs in each mode on the card and on the CPU, each on its own copy
    of the stream: counts and every z file equal bitwise."""
    import tempfile

    from repro_torch.api import APSLDA, HybridRoute, LDAJob
    from repro_torch.data import stream
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(300, 3000, true_topics=16, seed=seed)
    tokens = -(-corp.num_tokens // 4 // 1024) * 1024
    for extra in ({}, {"model_blocks": 4, "staleness": 1}):
        got = {}
        with tempfile.TemporaryDirectory() as tmp:
            for dev in ("cuda", "cpu"):
                path = str(Path(tmp) / dev)
                stream.write_sharded(path, corp, tokens)
                job = LDAJob(stream_dir=path, num_topics=64,
                             block_tokens=1024, epochs=2, eval_every=0,
                             seed=seed, route=HybridRoute(hot_words=200),
                             **extra)
                est = APSLDA(job, log_fn=lambda m: None, device=dev)
                est.fit()
                reader = est.result_.reader
                if reader.num_shards != 4:
                    raise AssertionError(f"{reader.num_shards} shards")
                got[dev] = (est.result_.nwk.value.cpu(),
                            est.result_.nk.value.cpu(),
                            [reader.read_z(s) for s in range(4)])
        equal = {"nwk": bool(torch.equal(got["cuda"][0], got["cpu"][0])),
                 "nk": bool(torch.equal(got["cuda"][1], got["cpu"][1])),
                 "z_files": all(np.array_equal(a, b) for a, b in
                                zip(got["cuda"][2], got["cpu"][2]))}
        mode = "blocked" if extra else "snapshot"
        log(json.dumps({"check": "stream_card_vs_cpu", "mode": mode,
                        "tokens": corp.num_tokens, "V": 3000, "K": 64,
                        "shards": 4, "equal": equal}))
        if not all(equal.values()):
            raise AssertionError(f"streamed {mode} training on the card "
                                 f"differs from the CPU: {equal}")


def service(torch, seed: int, card: str, corp, docs,
            device: str = "cuda", v: int = V_FULL, k: int = K_FULL,
            sweeps: int = 2, clients: int = N_CLIENTS,
            per_client: int = PER_CLIENT) -> dict:
    """TopicService at (v, k): the training corpus's initial state
    published, then ``train_async`` (``sweeps`` sweeps, a publish after
    each) while ``clients`` closed-loop threads submit ``per_client``
    requests each through ``start_serving``.  Every request is served or
    typed-shed, at least one swap lands under load, θ sums to 1."""
    from repro_torch import obs
    from repro_torch import rng as jrng
    from repro_torch.api import HybridRoute
    from repro_torch.core.lightlda import LDAConfig
    from repro_torch.infer.engine import DeadlineExceeded, EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.serve import TopicService
    from repro_torch.train.async_exec import ExecConfig

    obs_dir = ROOT / "chiprun_out" / "service_obs"
    cfg = LDAConfig(num_topics=k, vocab_size=v)
    with obs.session(obs.ObsConfig(enabled=True, out_dir=str(obs_dir))):
        svc = TopicService(cfg, EngineConfig(),
                           exec_cfg=ExecConfig(
                               route=HybridRoute(hot_words=HOT_WORDS)),
                           device=device)
        svc.init_from_corpus(corp, seed=seed)
        svc.publisher.publish_state(svc.state)
        svc.start_serving()
        v0 = svc.version
        lock = threading.Lock()
        served, shed, errors, latency = [], [], [], []

        def client(ci: int) -> None:
            # closed loop: each request waits for its answer before the next
            for i in range(per_client):
                j = ci * per_client + i
                ts = time.perf_counter()
                try:
                    r = svc.submit(docs[j % len(docs)],
                                   seed=5000 + j).result(timeout=600)
                    with lock:
                        served.append(r)
                        latency.append((time.perf_counter() - ts) * 1e3)
                except DeadlineExceeded as exc:
                    with lock:
                        shed.append(exc)
                except Exception as exc:   # noqa: BLE001 -- the verdict
                    with lock:
                        errors.append(exc)

        ops.reset_launch_counts()
        # --------------------------------------------------------- main path
        t0 = time.perf_counter()
        trainer = svc.train_async(sweeps, jrng.PRNGKey(seed + 3),
                                  publish_every=1)
        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        trainer.join(timeout=900)
        train_s = time.perf_counter() - t0
        svc.stop_serving()
        sync(torch, device)
        counts = ops.launch_counts()
        # ------------------------------------------------- end of main path
        reg = obs.metrics_registry()
        lag = reg.get("serve.version_lag")
        lag_max = max((val for _, val in lag.series), default=0.0) \
            if lag is not None else None
    events, _ = read_obs(obs_dir)
    publish_ms = [sum(x) for x in zip(*(span_ms(events, f"snapshot.{p}")
                                         for p in ("pull", "build", "sync",
                                                   "swap")))]
    total = clients * per_client
    swaps = svc.version - v0
    versions = sorted({r.version for r in served})
    sums = [float(r.theta.sum()) for r in served]
    # a swap under load: a publish landed while requests were being served
    # (a batch answered from a new version, or one answered from an older
    # version than the newest published)
    ok = {"no_errors": not errors,
          "all_served_or_shed": len(served) + len(shed) == total,
          "swap_under_load": swaps >= 1 and (len(versions) > 1
                                             or (lag_max or 0) >= 1),
          "theta_sums_to_1": all(abs(s - 1.0) < 1e-3 for s in sums),
          "trainer_finished": not trainer.running}
    row = {"requests": total, "served": len(served), "shed": len(shed),
           "errors": [repr(e) for e in errors[:3]],
           "req_per_s": len(served) / wall, "wall_s": wall,
           "train_s": train_s,
           "p50_ms": float(np.percentile(latency, 50)) if latency else None,
           "p90_ms": float(np.percentile(latency, 90)) if latency else None,
           "swaps": swaps, "served_versions": versions,
           "version_lag_max": lag_max, "publish_ms": publish_ms,
           "launches": counts, "checks": ok,
           "card": card}
    log(json.dumps({"service": row}))
    if not all(ok.values()):
        raise AssertionError(f"service under live refresh failed: {ok}")
    if device == "cuda" and not (counts["mh_sample"] and counts["delta_push"]
                                 and counts["alias_build"]
                                 and counts["mh_draws_train"]
                                 and counts["mh_draws_foldin"]):
        raise AssertionError(f"service: kernels not launched: {counts}")
    return row


def launchers(torch, card: str, device: Optional[str] = None) -> dict:
    """Both command-line entry points, in this process, on the default
    device (the card) unless ``device`` is given: the serving launcher's
    selftest, then a small streamed training run with checkpoints and its
    resume, which must print the resume line and write history.json."""
    import contextlib
    import io
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import lda, topic_serve

    dev = [] if device is None else ["--device", device]
    out = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # ------------------------------------------------------------ main path
    rc = topic_serve.main(["--selftest", *dev])
    # ---------------------------------------------------- end of main path
    out["topic_serve"] = {"rc": rc, "s": time.perf_counter() - t0,
                          "launches": ops.launch_counts()}
    if rc != 0:
        raise AssertionError(f"topic_serve --selftest returned {rc}")
    with tempfile.TemporaryDirectory() as tmp:
        base = ["--docs", "400", "--vocab", "2000", "-k", "50",
                "--block-tokens", "4096", "--stream-shard-tokens", "8192",
                "--stream-dir", str(Path(tmp) / "stream"), "--eval-every",
                "2", "--out", str(Path(tmp) / "out"), *dev]
        runs = []
        ops.reset_launch_counts()
        for argv in (["--epochs", "2", "--checkpoint-every", "2"],
                     ["--epochs", "3", "--resume"]):
            buf = io.StringIO()
            t0 = time.perf_counter()
            # ---------------------------------------------------- main path
            with contextlib.redirect_stdout(buf):
                rc = lda.main(base + argv)
            # -------------------------------------------- end of main path
            text = buf.getvalue()
            sys.stdout.write(text)
            hist = json.loads((Path(tmp) / "out" / "history.json")
                              .read_text())
            runs.append({"argv": argv, "rc": rc, "s": time.perf_counter() - t0,
                         "history_rows": len(hist),
                         "resumed": "[stream] resumed at epoch 2 pos 0"
                         in text})
            (Path(tmp) / "out" / "history.json").unlink()
        out["lda"] = {"runs": runs, "launches": ops.launch_counts()}
    log(json.dumps({"launchers": dict(out, card=card)}))
    if not (all(r["rc"] == 0 and r["history_rows"] for r in runs)
            and runs[1]["resumed"]):
        raise AssertionError(f"launch.lda stream run or resume failed: "
                             f"{runs}")
    counts = out["lda"]["launches"]
    if (device or "cuda") == "cuda" and not (
            counts["mh_sample"] and counts["delta_push"]
            and counts["alias_build"]
            and counts["mh_draws_train"] == counts["mh_sample"]):
        raise AssertionError(f"launch.lda: kernels not launched: {counts}")
    return out


# -- phases 10-11: tiered storage and the autotuner --------------------------

TIER_BLOCKS, TIER_HOT = 64, 8192     # the 400 MB table's 1/8 on the card


def z_update_ms(metrics: dict) -> Optional[dict]:
    """The z update's device ms per sweep (or streamed visit) of a training
    run, from its obs metrics: the ``exec.z_update_ms`` histogram the
    pipelined executor records on the card (CUDA events around the
    update); None off the card."""
    h = metrics.get("exec.z_update_ms")
    if h is None:
        return None
    return {key: h[key] for key in ("count", "mean", "min", "max")}


def nonempty_blocks(w: np.ndarray, rows_per_block: int) -> int:
    """Model blocks that hold a token of the word ids ``w``."""
    return int(np.unique(w // rows_per_block).size)


def tier_summary(est, obs_dir: Path) -> dict:
    """A tiered fit's tier: hit rate, promotions, evictions, cold-tier
    traffic (rows read up, rows written back), hot rows, the
    ``exec.tiered.device_table_bytes`` gauge and the sweep and refresh
    spans."""
    s = est.result_.nwk.tier_stats()
    events, metrics = read_obs(obs_dir)
    return {"hit_rate": s.hit_rate(), "hits": s.hits, "misses": s.misses,
            "promotions": s.promotions, "evictions": s.evictions,
            "h2d_mib": s.h2d_bytes / 2 ** 20,
            "write_back_mib": s.d2h_bytes / 2 ** 20,
            "hot_rows": est.result_.nwk.tier.hot_rows,
            "device_table_bytes":
                metrics["exec.tiered.device_table_bytes"]["value"],
            "sweep_ms": span_ms(events, "exec.sweep"),
            "refresh_ms": span_ms(events, "tier.refresh")}


def tiered_block_inputs(torch, st, cfg, rows_per_block: int) -> dict:
    """The inputs of a tiered sweep's first model block (the hottest rows)
    from a trained tiered state, as ``make_tiered_executor`` gives them to
    its kernels: the block's pulled rows, their weights and alias tables,
    the block's token slots at its power-of-two cap, and the merge's
    tables."""
    from repro_torch import rng as jrng
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lightlda as lda
    from repro_torch.train import async_exec

    rpb = rows_per_block
    rows = st.nwk.pull_block(0, rpb).result().clone()
    w = st.w.cpu().numpy()
    tok = np.nonzero(st.valid.cpu().numpy() & (w < rpb))[0]
    cap = max(128, 1 << (int(tok.size) - 1).bit_length())
    idx = np.zeros(cap, np.int64)
    idx[: tok.size] = tok
    i = torch.from_numpy(idx).to(rows.device)
    valid = torch.arange(cap, device=rows.device) < tok.size
    nk = st.nk.value
    weights = async_exec._weights(rows, nk, cfg)
    table = alias_mod.build_alias_rows(weights)
    wb, db = st.w[i], st.d[i]
    local = torch.clamp(wb, 0, rpb - 1).to(torch.int32)
    rng = lda.draw_mh_randoms(
        jrng.PRNGKey(7, rows.device),
        lda.make_doc_draw(db, st.z, st.doc_start, st.doc_len, cfg), cap, cfg)
    args = (rng, st.z[i], local, db, rows.to(torch.float32), st.ndk,
            nk.to(torch.float32), table.prob, table.alias)
    return {"args": args, "valid": valid, "weights": weights,
            "tables": [rows, st.ndk.clone(), nk.clone()], "tokens": tok.size,
            "draws": (db, st.z, st.doc_start, st.doc_len, cap)}


def tiered_sweep_split(torch, st, cfg, info: dict, card: str) -> dict:
    """One more sweep of a trained tiered state under the profiler: wall
    and device busy ms, and device ms and launches by part -- the miss
    path's and the write-back's copies, B2, B1, B3, the index copies (z,
    hot tier, compose), the rest (the threefry draws, gathers, fills)."""
    from repro_torch import rng as jrng
    from repro_torch.train import async_exec

    step, _ = async_exec.make_tiered_executor(
        st, cfg, async_exec.ExecConfig(model_blocks=TIER_BLOCKS),
        refresh_every=0)
    wall_ms, busy_ms, stats = device_profile(
        torch, lambda: step.raw(st, jrng.PRNGKey(29, "cuda")))
    (ROOT / "chiprun_out" / "tiered_profile.txt").write_text(
        f"{card}\none tiered sweep, {info['n_blocks']} blocks x "
        f"{info['rows_per_block']} rows, wall {wall_ms:.3f} ms (profiler "
        f"on), device busy {busy_ms:.3f} ms\n\n{profile_table(stats)}\n")
    parts = {"h2d": "Memcpy HtoD", "d2h": "Memcpy DtoH",
             "alias_build": "alias_build_kernel",
             "mh_sample": "mh_sample_kernel",
             "delta_push": "delta_push_kernel", "index_copy": "index_copy"}
    split = {name: of_kernel(stats, key) for name, key in parts.items()}
    named = sum(p["device_ms"] for p in split.values())
    split["rest"] = {"count": sum(n for n, _ in stats.values())
                     - sum(p["count"] for p in split.values()),
                     "device_ms": busy_ms - named}
    for name in ("alias_build", "mh_sample", "delta_push"):
        if not split[name]["count"]:
            raise AssertionError(f"the profile of a tiered sweep shows no "
                                 f"{name} launch")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "host_syncs": nonempty_blocks(st.w[st.valid].cpu().numpy(),
                                          info["rows_per_block"]),
            "by_part": split}


def tiered_train(torch, seed: int, card: str, corp, device: str = "cuda",
                 v: int = V_FULL, k: int = K_FULL, blocks: int = TIER_BLOCKS,
                 hot: int = TIER_HOT) -> dict:
    """Tiered storage at (v, k) on ``corp``: APSLDA with
    ``storage="tiered"``, ``model_blocks=blocks``, 3 sweeps, refresh every
    sweep, once with ``hot`` rows on the card and once auto-sized and
    auto-resized (``hot_rows=None``).  Each: exact conservation of the
    composed table, falling perplexity, launches (one mh_sample,
    alias_build and delta_push per non-empty block a sweep, no
    delta_apply_coo), the tier's traffic and the device-table gauge (at
    most 1/8 of the table with ``hot`` rows); the first model serves.
    Returns the first run's state, counts and a block's kernel inputs."""
    import tempfile

    from repro_torch.api import APSLDA, LDAJob, ObsConfig
    from repro_torch.kernels import ops

    out = {}
    table_bytes = v * k * 4
    with tempfile.TemporaryDirectory() as tmp:
        for name, hot_rows in (("hot", hot), ("auto", None)):
            obs_dir = ROOT / "chiprun_out" / "tiered_obs" / name
            job = LDAJob(corpus=corp, num_topics=k, vocab_size=v,
                         storage="tiered", model_blocks=blocks,
                         hot_rows=hot_rows, tier_refresh=1,
                         tier_dir=str(Path(tmp) / name), sweeps=3,
                         eval_every=1, seed=seed,
                         obs=ObsConfig(enabled=True, out_dir=str(obs_dir)))
            ops.reset_launch_counts()
            # -------------------------------------------------- main path
            est = APSLDA(job, log_fn=log, device=device)
            model = est.fit()
            sync(torch, device)
            counts = ops.launch_counts()
            # ------------------------------------------ end of main path
            info, st = est.result_.info, est.result_.state
            n = nonempty_blocks(corp.w, info["rows_per_block"]) * job.sweeps
            check_launches(counts, expected_launches(n, alias_builds=n),
                           f"tiered ({name})", device)
            conservation(torch, st, f"tiered ({name})")
            ppl = [row["perplexity"] for row in model.history]
            if not (len(ppl) == 3 and ppl[2] < ppl[0]):
                raise AssertionError(f"tiered ({name}): perplexity did not "
                                     f"fall: {ppl}")
            summary = tier_summary(est, obs_dir)
            if (hot_rows is not None
                    and summary["device_table_bytes"] > table_bytes / 8):
                raise AssertionError(
                    f"tiered: {summary['device_table_bytes']} bytes of "
                    f"table on the card, over 1/8 of {table_bytes}")
            row = {"run": name, "V": v, "K": k,
                   "blocks": info["n_blocks"],
                   "rows_per_block": info["rows_per_block"],
                   "nonempty_blocks": n // job.sweeps,
                   "token_caps": info["token_caps"],
                   "hot_rows_start": info["hot_rows"], **summary,
                   "tokens_per_s": [corp.num_tokens / (ms / 1e3)
                                    for ms in summary["sweep_ms"]],
                   "perplexity": ppl, "launches": counts, "card": card}
            log(json.dumps({"tiered_train": row}))
            out[name] = row
            if name == "hot":
                docs = make_docs(model.nwk, 64, seed + 9)
                theta = model.transform(docs, [4000 + i for i in range(64)])
                sums = theta.sum(1)
                if not (theta.shape == (64, k) and np.isfinite(theta).all()
                        and (np.abs(sums - 1.0) <= 1e-3).all()):
                    raise AssertionError("the tiered model's θ rows do not "
                                         "sum to 1")
                out.update(counts=counts, cfg=model.cfg, info=info)
                if device == "cuda":
                    out["block"] = tiered_block_inputs(
                        torch, st, model.cfg, info["rows_per_block"])
                    out["split"] = tiered_sweep_split(torch, st, model.cfg,
                                                      info, card)
                    log(json.dumps({"tiered_sweep_split": dict(
                        out["split"], refresh_ms=summary["refresh_ms"],
                        card=card)}))
            del est, model, st
    return out


def tiered_card_vs_cpu(torch, seed: int, card: str, train: dict) -> None:
    """(a) A small tiered job (V = 3,000, K = 64, 300 docs, 256 hot rows, 8
    model blocks, 2 sweeps) on the card and on the CPU: z, the composed
    n_wk, n_k and the cold-store files equal bitwise.  (b) One snapshot
    group of the trained full-width state through a tiered handle (8,192
    hot rows) with HybridRoute(2000): the hot words' reassignments through
    ``TieredMatrixHandle.push`` (delta_push in slot space), the cold tail's
    COO buffer through ``push_coo`` (delta_apply_coo on its resident
    entries), one launch each; the composed table equals the dense
    handle's routed push."""
    import tempfile

    from repro_torch import ps
    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.kernels import delta_push, mh_sample, ops

    corp = synthetic_corpus(300, 3000, true_topics=16, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for dev in ("cuda", "cpu"):
            job = LDAJob(corpus=corp, num_topics=64, vocab_size=3000,
                         storage="tiered", hot_rows=256, model_blocks=8,
                         sweeps=2, eval_every=0, seed=seed,
                         tier_dir=str(Path(tmp) / dev))
            est = APSLDA(job, log_fn=lambda m: None, device=dev)
            est.fit()
            st = est.result_.state
            runs[dev] = {"z": st.z.cpu(), "nwk": st.nwk.to_dense().cpu(),
                         "nk": st.nk.value.cpu(), "ndk": st.ndk.cpu()}
        equal = {name: bool(torch.equal(runs["cuda"][name],
                                        runs["cpu"][name]))
                 for name in runs["cpu"]}
        for name in ("coldstore.json", "table.int32"):
            equal[name] = ((Path(tmp) / "cuda" / name).read_bytes()
                           == (Path(tmp) / "cpu" / name).read_bytes())
    log(json.dumps({"check": "tiered_card_vs_cpu", "V": 3000, "K": 64,
                    "tokens": corp.num_tokens, "equal": equal}))
    if not all(equal.values()):
        raise AssertionError(f"tiered training on the card differs from the "
                             f"CPU: {equal}")

    st, cfg = train["state"], train["cfg"]
    args, valid = snapshot_group_inputs(torch, train)
    got = mh_sample.mh_sample_cuda(*args, cfg, frozen=False)
    w, z0 = args[2], args[1]
    z_new = torch.where(valid, got, z0)
    changed = (z_new != z0) & valid
    route = ps.HybridRoute(hot_words=HOT_WORDS)
    want = st.nwk.with_route(route).push(
        ps.Reassign(w, w, z0, z_new, changed)).to_dense()
    hot, cold = delta_push.split_hot_cold(w, changed, HOT_WORDS)
    coo = delta_push.cold_coo(w, z0, z_new, cold)
    with tempfile.TemporaryDirectory() as tmp:
        tiered = ps.tiered_matrix_from_dense(st.nwk.to_dense(), TIER_HOT,
                                             tmp, route=route, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        # ------------------------------------------------------ main path
        tiered.push(ps.Reassign(w, w, z0, z_new, hot))
        tiered.push_coo(*coo)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        # ---------------------------------------------- end of main path
        equal = bool(torch.equal(tiered.to_dense(), want))
        stats = tiered.tier_stats().to_json()
    log(json.dumps({"tiered_push": {
        "route": repr(route), "hot_rows": TIER_HOT,
        "tokens": int(w.shape[0]), "hot_changed": int(hot.sum()),
        "cold_changed": int(cold.sum()), "launches": counts,
        "table_equals_dense_push": equal, "tier": stats, "card": card}}))
    if counts["delta_push"] != 1 or counts["delta_apply_coo"] != 1:
        raise AssertionError(f"the tiered push launched {counts}, expected "
                             f"one delta_push and one delta_apply_coo")
    if not equal:
        raise AssertionError("the tiered push's composed table differs from "
                             "the dense handle's")


def autotune_fit(torch, seed: int, card: str, corp, device: str = "cuda",
                 v: int = V_FULL, k: int = K_FULL) -> dict:
    """APSLDA with ``route="auto"``, ``staleness="auto"`` on the pipelined
    executor (16 model blocks), 2 sweeps: the measured route table (plan
    and apply ms per candidate), the staleness table (sweep ms, tokens/s)
    and the choice; then the same job with the chosen route and staleness,
    whose n_wk and n_k must equal the auto fit's bitwise."""
    from repro_torch.api import (APSLDA, CooRoute, DenseRoute, HybridRoute,
                                 LDAJob)
    from repro_torch.kernels import ops

    job = LDAJob(corpus=corp, num_topics=k, vocab_size=v, route="auto",
                 staleness="auto", model_blocks=PIPE_BLOCKS, sweeps=2,
                 eval_every=0, seed=seed)
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    est = APSLDA(job, log_fn=log, device=device)
    model = est.fit()
    sync(torch, device)
    counts = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    fit_s = time.perf_counter() - t0
    # every group of every sweep (the staleness candidates' included) draws
    # its randoms in one launch beside its one mh_sample
    if device == "cuda" and not (
            counts["mh_sample"] and counts["alias_build"]
            and counts["mh_draws_train"] == counts["mh_sample"]
            and not counts["mh_draws_foldin"]):
        raise AssertionError(f"autotune: launches {counts}: expected one "
                             f"mh_draws_train per mh_sample")
    report = est.result_.info["autotune"]
    chosen = report["chosen"]
    conservation(torch, est.result_.state, "autotuned fit")
    route = (HybridRoute(hot_words=chosen["hot_words"])
             if chosen["hot_words"] is not None
             else {"dense": DenseRoute(), "coo": CooRoute()}[chosen["route"]])
    concrete = dataclasses.replace(job, route=route,
                                   staleness=chosen["staleness"])
    cmodel = APSLDA(concrete, log_fn=lambda m: None, device=device).fit()
    equal = {"nwk": bool(np.array_equal(model.nwk, cmodel.nwk)),
             "nk": bool(np.array_equal(model.nk, cmodel.nk))}
    routes = [{key: r[key] for key in ("route", "hot_words", "plan_ms",
                                       "apply_ms")}
              for r in report["route"]["measured"]]
    out = {"V": v, "K": k, "batch": report["route"]["batch"],
           "predicted_order": report["route"]["predicted_order"],
           "routes": routes, "staleness": report["staleness"]["measured"],
           "chosen": chosen, "fit_s": fit_s, "launches": counts,
           "equal_to_concrete_fit": equal, "card": card}
    log(json.dumps({"autotune": out}))
    if not all(equal.values()):
        raise AssertionError(f"the autotuned fit differs from the fit with "
                             f"its chosen plan: {equal}")
    return out


# -- phase 12: the network parameter server ----------------------------------

NET_WORKERS = 2


def worker_launches(stats: dict, groups_per_visit: int) -> dict:
    """What one snapshot-mode worker must have launched for its visits: one
    mh_draws_train, mh_sample and delta_push a group, one alias_build a
    visit, nothing else."""
    return expected_launches(stats["visits"] * groups_per_visit,
                             alias_builds=stats["visits"])


def net_summary(info: dict, n_tokens: int) -> dict:
    """Throughput and the per-visit split of a net run from its workers'
    stats and the server's status."""
    stats = info["worker_stats"]
    start = min(s["wall"][0] for s in stats if s["wall"][0] is not None)
    end = max(s["wall"][1] for s in stats if s["wall"][1] is not None)
    status = info["server_status"]
    return {"workers": len(stats), "tokens": n_tokens,
            "window_s": end - start, "tokens_per_s": n_tokens / (end - start),
            "visits": [s["visits"] for s in stats],
            "visit_ms": [s["visit_ms"] for s in stats],
            "server_commit_ms_median": status["commit_ms_median"],
            "superseded": [s["superseded"] for s in stats],
            "retries": [s["retries"] for s in stats],
            "reconnects": [s["reconnects"] for s in stats],
            "dup_acks": status["dup_acks"],
            "max_memory_allocated": [s["max_memory_allocated"]
                                     for s in stats],
            "devices": [s["device"] for s in stats],
            "launches": [s["launches"] for s in stats]}


def net_train(torch, seed: int, card: str, corp, device: str = "cuda",
              v: int = V_FULL, k: int = K_FULL,
              tokens_per_shard: int = STREAM_SHARD_TOKENS,
              block_tokens: int = 8192, reference: Optional[dict] = None,
              small_v: int = 3000, small_k: int = 64) -> dict:
    """Training through the network parameter server at (v, k) on ``corp``
    in shards of ``tokens_per_shard``, the job of stream_train's snapshot
    run (hot words 2,000, committed as the dense prefix; the same seed):

      (a) one worker, 2 epochs: n_wk, n_k and every z file equal the
          in-process stream plane's (``reference``: stream_train's result,
          or a run made here) bitwise;
      (b) two workers, 2 epochs, dynamic leases: exact conservation (the
          server's counts are the z files' histogram, the token mass
          unchanged), the perplexity falling, and each worker's own launch
          counters: one mh_draws_train, mh_sample and delta_push a group
          and one alias_build a visit, on the card;
      (c) ``python -m repro_torch.launch.net_smoke --device <device>
          --workers 2``: faults on every op, one worker SIGKILLed; exit 0;
      (d) on the card only: a 1-worker job at (small_v, small_k) on the
          card and on the CPU, counts and z files bitwise equal.

    Prints tokens/s with 1 and 2 workers (first granted lease to last
    commit), each worker's median host ms per part of a visit, the
    server's median ms to apply a commit, superseded commits, retries,
    reconnects and each worker's peak device memory."""
    import tempfile

    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data import stream
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.kernels import ops

    out = {}
    groups_per_visit = tokens_per_shard // block_tokens
    with tempfile.TemporaryDirectory() as tmp:
        names = ("one", "two") + (("ref",) if reference is None else ())
        dirs = {n: str(Path(tmp) / n) for n in names}
        meta = [stream.write_sharded(p, corp, tokens_per_shard)
                for p in dirs.values()][0]
        n_shards = meta.num_shards
        job = LDAJob(stream_dir=dirs["one"], num_topics=k, vocab_size=v,
                     backend="net", workers=1, hot_words=HOT_WORDS, epochs=2,
                     seed=seed, block_tokens=block_tokens, eval_every=0)
        if reference is None:
            ref_est = APSLDA(stream_job(dirs["ref"], k, v, seed, 2,
                                        block_tokens=block_tokens,
                                        eval_every=0),
                             log_fn=lambda m: None, device=device)
            ref_est.fit()
            reader = ref_est.result_.reader
            reference = {"nwk": ref_est.result_.nwk.value.cpu().numpy(),
                         "nk": ref_est.result_.nk.value.cpu().numpy(),
                         "z": [reader.read_z(s) for s in range(n_shards)]}
            del ref_est

        # (a) one worker against the in-process stream plane
        ops.reset_launch_counts()
        # ------------------------------------------------------- main path
        est = APSLDA(job, log_fn=log, device=device)
        est.fit()
        sync(torch, device)
        parent = ops.launch_counts()
        # ----------------------------------------------- end of main path
        res = est.result_
        equal = {"nwk": bool(np.array_equal(res.nwk.value.cpu().numpy(),
                                            reference["nwk"])),
                 "nk": bool(np.array_equal(res.nk.value.cpu().numpy(),
                                           reference["nk"])),
                 "z_files": all(np.array_equal(res.reader.read_z(s), z)
                                for s, z in enumerate(reference["z"]))}
        one = net_summary(res.info, 2 * meta.num_tokens)
        out["one_worker"] = dict(one, equal_to_stream_plane=equal,
                                 parent_launches=parent)
        log(json.dumps({"net": dict(out["one_worker"], run="1 worker",
                                    card=card)}))
        if not all(equal.values()):
            raise AssertionError(f"the 1-worker net run differs from the "
                                 f"stream plane: {equal}")
        for st in res.info["worker_stats"]:
            check_launches(st["launches"],
                           worker_launches(st, groups_per_visit),
                           "net worker (1 worker)", device)
        del est, res

        # (b) two workers, dynamic leases
        job2 = dataclasses.replace(job, stream_dir=dirs["two"],
                                   workers=NET_WORKERS, eval_every=n_shards)
        ops.reset_launch_counts()
        # ------------------------------------------------------- main path
        est = APSLDA(job2, log_fn=log, device=device)
        model = est.fit()
        sync(torch, device)
        parent = ops.launch_counts()
        # ----------------------------------------------- end of main path
        res = est.result_
        rw, rk = stream.rebuild_counts_from_stream(res.reader, k)
        nwk, nk = res.nwk.value.cpu().numpy(), res.nk.value.cpu().numpy()
        ppl = [row["perplexity"] for row in model.history]
        checks = {"nwk_is_z_histogram": bool(np.array_equal(nwk, rw)),
                  "nk_is_z_histogram": bool(np.array_equal(nk, rk)),
                  "token_mass": int(nk.sum()) == meta.num_tokens,
                  "perplexity_falls": len(ppl) == 2 and ppl[1] < ppl[0],
                  "all_visits": sum(st["visits"] for st in
                                    res.info["worker_stats"])
                  == 2 * n_shards}
        two = net_summary(res.info, 2 * meta.num_tokens)
        out["two_workers"] = dict(two, perplexity=ppl, checks=checks,
                                  parent_launches=parent)
        log(json.dumps({"net": dict(out["two_workers"], run="2 workers",
                                    card=card)}))
        if not all(checks.values()):
            raise AssertionError(f"the 2-worker net run failed: {checks}")
        for st in res.info["worker_stats"]:
            check_launches(st["launches"],
                           worker_launches(st, groups_per_visit),
                           "net worker (2 workers)", device)
            if device == "cuda" and not (st["visits"]
                                         and st["device"] == card_name(card)):
                raise AssertionError(f"a net worker did not train on the "
                                     f"card: {st}")
        del est, res, model, nwk, rw

    # (c) the fault drill, as a user runs it
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.net_smoke", "--device",
         device, "--workers", "2"], capture_output=True, text=True,
        timeout=900, cwd=str(ROOT),
        env=dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src")))
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    out["net_smoke"] = {"rc": proc.returncode,
                        "s": time.perf_counter() - t0, "last": tail[0]}
    log(json.dumps({"net_smoke": dict(out["net_smoke"], card=card)}))
    if proc.returncode != 0:
        raise AssertionError(f"net_smoke failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")

    # (d) card against CPU at a small width
    if device == "cuda":
        small = synthetic_corpus(300, small_v, true_topics=16, seed=seed)
        sjob = LDAJob(corpus=small, num_topics=small_k, vocab_size=small_v,
                      backend="net", workers=1, hot_words=200, sweeps=2,
                      block_tokens=1024, eval_every=0, seed=seed)
        runs = {}
        for dev in ("cuda", "cpu"):
            est = APSLDA(sjob, log_fn=lambda m: None, device=dev)
            est.fit()
            r = est.result_
            runs[dev] = (r.nwk.value.cpu().numpy(), r.nk.value.cpu().numpy(),
                         [r.reader.read_z(s)
                          for s in range(r.reader.num_shards)])
        equal = {"nwk": bool(np.array_equal(runs["cuda"][0],
                                            runs["cpu"][0])),
                 "nk": bool(np.array_equal(runs["cuda"][1], runs["cpu"][1])),
                 "z_files": all(np.array_equal(a, b) for a, b in
                                zip(runs["cuda"][2], runs["cpu"][2]))}
        log(json.dumps({"check": "net_card_vs_cpu", "V": small_v,
                        "K": small_k, "tokens": small.num_tokens,
                        "equal": equal}))
        if not all(equal.values()):
            raise AssertionError(f"net training on the card differs from "
                                 f"the CPU: {equal}")
    return out


def card_name(card: str) -> str:
    """The card's name from the ``nvidia-smi`` line (name, power limit)."""
    return card.split(",")[0].strip()


def tiered_kernel_rows(torch, timer: Timer, tiered: dict, card: str) -> list:
    """B1, B2 and B3's merge form at a tiered block's shapes (the first
    block's rows, its slots at its power-of-two cap, n_dk and n_k of the
    trained state): each held bitwise against its plain version first,
    then timed, with the launches of the tiered run."""
    from repro_torch.kernels import mh_sample

    blk, cfg, counts = tiered["block"], tiered["cfg"], tiered["counts"]
    args, valid = blk["args"], blk["valid"]
    got = mh_sample.mh_sample_cuda(*args, cfg, frozen=False)
    want = mh_sample_ref_chunked(torch, args, cfg, frozen=False)
    if not torch.equal(got, want):
        raise AssertionError("mh_sample differs from its plain version at "
                             "a tiered block's shapes")
    ms = timer.ms(lambda: mh_sample.mh_sample_cuda(*args, cfg, frozen=False),
                  reps=30)
    plain_ms = timer.ms(lambda: mh_sample_ref_chunked(
        torch, args, cfg, frozen=False), reps=3, device_only=False)
    t = args[1].shape[0]
    rows = [kernel_row(
        "mh_sample_train_tiered", "src/repro_torch/kernels/csrc/mh_sample.cu",
        "src/repro/kernels/mh_sample.py:34", counts["mh_sample"], 0.0, ms,
        plain_ms, mh_sample_bytes(torch, *args), cfg.mh_steps * t * 60)]
    rows.append(alias_row(torch, timer, "alias_build_train_tiered",
                          blk["weights"], counts["alias_build"], 10, card))
    z0 = args[1]
    z_new = torch.where(valid, got, z0)
    batch = (args[2], z0, z_new, (z_new != z0) & valid, args[3])
    tables = blk["tables"]
    want_t = [x.clone() for x in tables]
    merge_ref(torch, batch, want_t)
    got_t = [x.clone() for x in tables]
    merge_cuda(torch, batch, got_t)
    if not all(torch.equal(a, b) for a, b in zip(got_t, want_t)):
        raise AssertionError("delta_push's merge differs from its plain "
                             "version at a tiered block's shapes")
    nbytes, sectors = merge_bytes(torch, batch, tables)
    mms = timer.ms(lambda: merge_cuda(torch, batch, tables), reps=50)
    mplain = timer.ms(lambda: merge_ref(torch, batch, tables), reps=5,
                      device_only=False)
    n_changed = int(batch[3].sum())
    rows.append(kernel_row(
        "delta_push_train_tiered",
        "src/repro_torch/kernels/csrc/delta_push.cu",
        "src/repro/kernels/delta_push.py:39", counts["delta_push"], 0.0, mms,
        mplain, nbytes, t * 4 + n_changed * 12))
    log(json.dumps({"timing": {"tiered_block": {
        "rows": tables[0].shape[0], "K": cfg.K, "slots": t,
        "tokens": blk["tokens"], "changed": n_changed, "sectors": sectors,
        "mh_sample_ms": ms, "merge_ms": mms, "bitwise": True,
        "card": card}}}))
    return rows


# -- phase 5: kernel times at the main path's shapes -------------------------

def main_path_mh_inputs(torch, model, docs, seeds):
    """The inputs the main path gives mh_sample for one full batch of the
    longest bucket, at the first sweep."""
    from repro_torch import rng as jrng
    from repro_torch.core import lightlda as lda
    from repro_torch.infer.foldin import _doc_randoms, _ndk_from_z, pack_docs

    eng, cfg = model.engine(), model.cfg
    mb, bucket = eng.ecfg.max_batch, eng.ecfg.max_len
    pick = sorted(range(len(docs)), key=lambda j: -len(docs[j]))[:mb]
    w, valid = pack_docs([docs[j] for j in pick], bucket)
    dev = model.device
    w, valid = torch.from_numpy(w).to(dev), torch.from_numpy(valid).to(dev)
    keys = jrng.keys_from_seeds([seeds[j] for j in pick], dev)
    b, l = w.shape
    nd = valid.to(torch.int32).sum(1, dtype=torch.int32)
    z = jrng.randint(jrng.fold_in(keys, 0x1d4), (l,), 0, cfg.K)
    rng = lda.MHRandoms(*(r.transpose(0, 1).reshape(cfg.mh_steps, b * l)
                          .contiguous() for r in _doc_randoms(
                              jrng.fold_in(keys, 0), z, nd, cfg)))
    m = model.snapshot.model
    d = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(l)
    return (rng, z.reshape(-1), w.reshape(-1).to(torch.int32), d, m.nwk,
            _ndk_from_z(z, valid, cfg.K), m.nk, m.aprob, m.aalias)


def mh_sample_bytes(torch, rng, z0, w, d, nwk, ndk, nk, aprob,
                    aalias) -> int:
    """The bytes one mh_sample call must move on these inputs.

    Per token: z0, w and d in and z out, and four randoms per step, each
    once.  The tables are gathered, so each 32-byte sector the chain reads
    counts once, however many tokens read it.  The chain reads n_wk, n_dk
    and n_k at the columns {z0} and each step's word and doc proposals (the
    current topic is always one of these), aprob at each step's bucket, and
    aalias at the buckets whose coin rejects.
    """
    k = nwk.shape[1]
    w64, d64 = w.long(), d.long()
    cols, rows_b, cols_b, alias_b = [z0.long()], [], [], []
    for s in range(rng.u_word.shape[0]):
        scaled = rng.u_word[s] * k              # as core.alias.alias_sample
        bucket = torch.clamp_max(scaled.to(torch.int32), k - 1).long()
        rejected = (scaled - bucket) >= aprob[w64, bucket]
        cols += [torch.where(rejected, aalias[w64, bucket].long(), bucket),
                 rng.z_doc[s].long()]
        rows_b.append(w64)
        cols_b.append(bucket)
        alias_b.append(rejected)

    def sectors(rows, c, ncols):
        return int(torch.unique((rows * ncols + c) // (SECTOR // 4)).numel())

    c = torch.cat(cols)
    n = len(cols)
    rb, cb, ab = torch.cat(rows_b), torch.cat(cols_b), torch.cat(alias_b)
    gathered = (sectors(w64.repeat(n), c, k) + sectors(d64.repeat(n), c, k)
                + sectors(torch.zeros_like(c), c, k) + sectors(rb, cb, k)
                + sectors(rb[ab], cb[ab], k))
    t, steps = z0.shape[0], rng.u_word.shape[0]
    return t * 16 + steps * t * 16 + gathered * SECTOR


def snapshot_group_inputs(torch, train: dict):
    """mh_sample's inputs in the snapshot executor's first group (8192
    tokens) of a sweep of the trained state: the [V, K] snapshot and its
    alias tables, the [D, K] n_dk.  Returns them and the group's ``valid``."""
    from repro_torch import rng as jrng
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lightlda as lda

    st, cfg = train["state"], train["cfg"]
    g = cfg.block_tokens
    w_b, d_b = st.w[:g], st.d[:g]
    nwk_dense, nk = st.nwk.to_dense(), st.nk.value
    table = alias_mod.build_alias_rows(
        (nwk_dense.to(torch.float32) + cfg.beta)
        / (nk.to(torch.float32)[None, :] + cfg.V * cfg.beta))
    rng = lda.draw_mh_randoms(
        jrng.PRNGKey(7, "cuda"),
        lda.make_doc_draw(d_b, st.z, st.doc_start, st.doc_len, cfg), g, cfg)
    return ((rng, st.z[:g].clone(), w_b, d_b, nwk_dense.to(torch.float32),
             st.ndk, nk.to(torch.float32), table.prob, table.alias),
            st.valid[:g])


def pipelined_group_rows(train: dict):
    """The pipelined executor's (16 model blocks, staleness 1) rows per
    group and its first group's pulled [rows, K] counts, from the trained
    state."""
    from repro_torch.train import async_exec

    st = train["state"]
    rpb, _, s = async_exec.blocked_geometry(st.nwk.layout, PIPE_BLOCKS,
                                            PIPE_STALENESS)
    grp_rows = rpb * (s + 1)
    return grp_rows, st.nwk.pull_block(0, grp_rows).result()


def pipelined_group_inputs(torch, train: dict, index=None):
    """mh_sample's inputs in the pipelined executor's first group (16 model
    blocks, staleness 1) of a sweep of the trained state: the group's
    pulled rows and their alias tables, block-local row indices, and the
    group's padded token slots (from ``index``, the blocked token index
    (idx, bval) as numpy arrays, if given; else the in-memory executor's).
    Returns them, the slots' ``valid`` and their logical word ids."""
    from repro_torch import rng as jrng
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lightlda as lda

    st, cfg = train["state"], train["cfg"]
    layout = st.nwk.layout
    grp_rows, rows = pipelined_group_rows(train)
    idx, bval = index or lda.block_token_index(
        st.w.cpu().numpy(), st.valid.cpu().numpy(), grp_rows, layout)
    i = torch.from_numpy(idx[0]).to("cuda").long()
    nk = st.nk.value
    table = alias_mod.build_alias_rows(
        (rows.to(torch.float32) + cfg.beta)
        / (nk.to(torch.float32)[None, :] + cfg.V * cfg.beta))
    wb, db = st.w[i], st.d[i]
    local = torch.clamp(layout.to_physical(wb), 0, grp_rows - 1).to(
        torch.int32)
    rng = lda.draw_mh_randoms(
        jrng.PRNGKey(7, "cuda"),
        lda.make_doc_draw(db, st.z, st.doc_start, st.doc_len, cfg),
        i.shape[0], cfg)
    return ((rng, st.z[i], local, db, rows.to(torch.float32), st.ndk,
             nk.to(torch.float32), table.prob, table.alias),
            torch.from_numpy(bval[0]).to("cuda"), wb)


def mh_sample_ref_chunked(torch, args, cfg, frozen: bool):
    """mh_sample's plain version over REF_CHUNK tokens at a time: its [T, K]
    gathers of a pipelined group's 1.8 M slots would not fit the card at
    once.  Tokens are independent, so the result is the same."""
    from repro_torch.core import lightlda as lda
    from repro_torch.kernels import ref

    rng, z0, w, d, *tables = args
    out = []
    for lo in range(0, z0.shape[0], REF_CHUNK):
        sl = slice(lo, lo + REF_CHUNK)
        part = lda.MHRandoms(*(r[:, sl] for r in rng))
        out.append(ref.mh_sample_ref(part, z0[sl], w[sl], d[sl], *tables,
                                     cfg, frozen=frozen))
    return torch.cat(out)


def training_mh_rows(torch, timer: Timer, train: dict, card: str):
    """mh_sample in training mode (``frozen=False``) at each executor's
    group shape: held bitwise against its plain version, timed, and reported
    as its own row with the launches of that executor's run.  Returns the
    rows and, per executor, its group's reassignments: (rows, words, docs,
    z_old, z_new, changed), as its merge receives them."""
    from repro_torch.kernels import mh_sample

    cfg = train["cfg"]
    rows, groups = [], {}
    for executor, reps, ref_reps in (("snapshot", 30, 3),
                                     ("pipelined", 5, 1)):
        if executor == "snapshot":
            args, valid = snapshot_group_inputs(torch, train)
            words = args[2]
        else:
            args, valid, words = pipelined_group_inputs(torch, train)
        got = mh_sample.mh_sample_cuda(*args, cfg, frozen=False)
        want = mh_sample_ref_chunked(torch, args, cfg, frozen=False)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f"mh_sample (training) differs from its "
                                 f"plain version at the {executor} "
                                 f"executor's shapes")
        ms = timer.ms(lambda: mh_sample.mh_sample_cuda(*args, cfg,
                                                       frozen=False),
                      reps=reps)
        plain_ms = timer.ms(lambda: mh_sample_ref_chunked(
            torch, args, cfg, frozen=False), reps=ref_reps,
            device_only=False)
        t, s = args[1].shape[0], cfg.mh_steps
        rows.append(kernel_row(
            f"mh_sample_train_{executor}",
            "src/repro_torch/kernels/csrc/mh_sample.cu",
            "src/repro/kernels/mh_sample.py:34",
            train[f"{executor}_counts"]["mh_sample"], float(err), ms,
            plain_ms, mh_sample_bytes(torch, *args), s * t * 60))
        log(json.dumps({"timing": {f"mh_sample_train_{executor}": {
            "table_rows": args[4].shape[0], "K": cfg.K, "tokens": t,
            "ndk_rows": args[5].shape[0], "match": True, "ms": ms,
            "card": card}}}))
        z0 = args[1]
        z_new = torch.where(valid, got, z0)
        groups[executor] = (args[2], words, args[3], z0, z_new,
                            (z_new != z0) & valid)
        del args, got, want
    return rows, groups


def touched_sectors(torch, rows, cols, k: int) -> int:
    """Distinct 32-byte sectors of a row-major int32 [R, k] buffer that
    the entries (rows, cols) fall in."""
    flat = rows.long() * k + cols.long()
    return int(torch.unique(flat // (SECTOR // 4)).numel())


def stream_sectors(torch, adds) -> int:
    """32-byte sectors of a [T] 4-byte stream that hold an entry for which
    ``adds`` is set: the sectors of an index stream that a function must
    read."""
    return int(torch.unique(torch.nonzero(adds).flatten()
                            // (SECTOR // 4)).numel())


def waits_on_host(torch, fn) -> bool:
    """Whether ``fn`` waits on the host for the device: a sleep kernel
    queued ahead of it is over by the time ``fn`` has returned."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 28)                # about 0.14 s
    held = torch.cuda.Event()
    held.record()
    fn()
    done = held.query()
    torch.cuda.synchronize()
    return done


def time_library(torch, timer: Timer, fn):
    """Device ms of one library call, and what the profiler saw of ten.

    The Timer's span holds at most 256 launches: a call launches several
    kernels, and once the device's launch queue is full behind the Timer's
    sleep, the host blocks as if the call waited on it (``waits_on_host``
    shows whether it does)."""
    reps = 10
    _, busy_ms, stats = device_profile(
        torch, lambda: [fn() for _ in range(reps)])
    seen = {"waits_on_host": waits_on_host(torch, fn),
            "kernels_per_call": sum(n for n, _ in stats.values()) / reps,
            "profiled_device_ms": busy_ms / reps}
    per_span = max(1, min(reps, int(256 // max(seen["kernels_per_call"], 1))))
    return timer.ms(fn, reps=per_span), seen


def delta_rows(torch, timer: Timer, train: dict, groups: dict,
               push_counts: dict, card: str) -> list:
    """Kernel rows of delta_push's single-destination form and of
    delta_apply_coo at the routed push's shapes (``routed_push``): one
    snapshot group's reassignments, the hybrid's hot tokens into the
    [2000, K] dense block and the cold tail's COO buffer into the [V, K]
    table, with that push's launches.  Each time is the kernel alone
    accumulating into a buffer made outside the span, as the library call
    (one index_put_ with accumulate, its flat indices and values made
    outside the span) is timed.  Bytes: the mask (B3) or the values (B4)
    read once per entry; of the index streams only the 32-byte sectors that
    hold an entry that adds; each touched 32-byte output sector read and
    written once."""
    from repro_torch.kernels import delta_push, ref

    w, _, _, zo, zn, changed = groups["snapshot"]
    nwk_dense = train["state"].nwk.to_dense()
    hot, cold_m = delta_push.split_hot_cold(w, changed, HOT_WORDS)
    cr, cc, cv = delta_push.cold_coo(w, zo, zn, cold_m)
    k = nwk_dense.shape[1]
    rows = []

    # B3, single destination: the hybrid's hot block [HOT_WORDS, K]
    h = HOT_WORDS
    got = delta_push.delta_push_cuda(w, zo, zn, hot, torch.zeros(
        (h, k), dtype=torch.int32, device="cuda"))
    want = ref.delta_push_ref(w, zo, zn, hot, h, k)
    err = int((got - want).abs().max())
    if err:
        raise AssertionError("delta_push differs from its plain version at "
                             "the routed push's shapes")
    buf = torch.zeros((h, k), dtype=torch.int32, device="cuda")
    ms = timer.ms(lambda: delta_push.delta_push_cuda(w, zo, zn, hot, buf),
                  reps=100)
    plain_ms = timer.ms(lambda: ref.delta_push_ref(w, zo, zn, hot, h, k),
                        reps=20, device_only=False)
    m = hot
    flat = torch.cat([w[m].long() * k + zo[m].long(),
                      w[m].long() * k + zn[m].long()])
    vals = torch.cat([-torch.ones_like(zo[m]), torch.ones_like(zn[m])])
    lib = torch.zeros(h * k, dtype=torch.int32, device="cuda")
    lib_ms, lib_seen = time_library(torch, timer, lambda: lib.index_put_(
        (flat,), vals, accumulate=True))
    n_hot = int(m.sum())
    sectors = touched_sectors(torch, torch.cat([w[m], w[m]]),
                              torch.cat([zo[m], zn[m]]), k)
    t = w.shape[0]
    nbytes = t + (3 * stream_sectors(torch, m) + 2 * sectors) * SECTOR
    rows.append(kernel_row(
        "delta_push", "src/repro_torch/kernels/csrc/delta_push.cu",
        "src/repro/kernels/delta_push.py:39", push_counts["delta_push"],
        float(err), ms, plain_ms, nbytes, t * 2 + n_hot * 8, lib_ms))
    log(json.dumps({"timing": {"delta_push": {
        "rows": h, "K": k, "tokens": t, "hot_changed": n_hot,
        "sectors": sectors, "library": lib_seen, "card": card}}}))

    # B4: the cold tail's COO buffer applied into the [V, K] table
    v = nwk_dense.shape[0]
    got = delta_push.delta_apply_coo_cuda(cr, cc, cv, nwk_dense.clone())
    want = ref.delta_apply_coo_ref(cr, cc, cv, v, k, out=nwk_dense.clone())
    err = int((got - want).abs().max())
    if err:
        raise AssertionError("delta_apply_coo differs from its plain "
                             "version at the routed push's shapes")
    del got, want
    table = nwk_dense.clone()
    ms = timer.ms(lambda: delta_push.delta_apply_coo_cuda(cr, cc, cv, table),
                  reps=100)
    plain_ms = timer.ms(lambda: ref.delta_apply_coo_ref(cr, cc, cv, v, k,
                                                        out=table), reps=20,
                        device_only=False)
    flat = cr.long() * k + cc.long()
    flat_table = table.view(-1)
    lib_ms, lib_seen = time_library(torch, timer, lambda: flat_table.index_put_(
        (flat,), cv, accumulate=True))
    nz = cv != 0
    n_nz = int(nz.sum())
    sectors = touched_sectors(torch, cr[nz], cc[nz], k)
    nbytes = cr.shape[0] * 4 + (2 * stream_sectors(torch, nz)
                                + 2 * sectors) * SECTOR
    rows.append(kernel_row(
        "delta_apply_coo", "src/repro_torch/kernels/csrc/delta_push.cu",
        "src/repro/kernels/delta_push.py:133",
        push_counts["delta_apply_coo"], float(err), ms, plain_ms, nbytes,
        cr.shape[0] * 2 + n_nz * 6, lib_ms))
    log(json.dumps({"timing": {"delta_apply_coo": {
        "rows": v, "K": k, "entries": cr.shape[0], "nonzero": n_nz,
        "sectors": sectors, "library": lib_seen, "card": card}}}))
    return rows


def group_tables(torch, train: dict, executor: str) -> list:
    """Fresh copies of the tables an executor's group merges into, from
    the trained state: [n_wk rows, n_dk, n_k] -- the whole [V, K] snapshot
    for the snapshot executor, the first group's pulled rows for the
    pipelined one."""
    st = train["state"]
    rows = (st.nwk.to_dense() if executor == "snapshot"
            else pipelined_group_rows(train)[1])
    return [rows, st.ndk.clone(), st.nk.value.clone()]


def merge_batch(groups: dict, executor: str):
    rows, _, docs, z0, z_new, changed = groups[executor]
    return rows, z0, z_new, changed, docs


def merge_bytes(torch, batch, tables):
    """The merge's bytes and the touched 32-byte sectors of its three
    tables: ``changed`` read once per token; of the index streams only the
    sectors that hold a token that adds (rows: a changed token inside n_wk,
    docs: inside n_dk, z_old/z_new: any changed token); each touched table
    sector read and written once."""
    r, zo, zn, changed, d = batch
    out, ndk, _ = tables
    k = out.shape[1]
    sectors, streams = 0, 2 * stream_sectors(torch, changed)
    for idx, n in ((r, out.shape[0]), (d, ndk.shape[0])):
        ok = changed & (idx >= 0) & (idx < n)
        streams += stream_sectors(torch, ok)
        sectors += touched_sectors(torch, torch.cat([idx[ok], idx[ok]]),
                                   torch.cat([zo[ok], zn[ok]]), k)
    sectors += touched_sectors(
        torch, torch.zeros_like(zo[changed]).repeat(2),
        torch.cat([zo[changed], zn[changed]]), k)
    return changed.shape[0] + (streams + 2 * sectors) * SECTOR, sectors


def merge_by_destination(torch, timer: Timer, batch, tables,
                         reps: int) -> dict:
    """Device ms of the merge kernel with fewer destinations, to see where
    its time goes: the token streams alone (no token changed: every load,
    no atomic), n_wk alone, n_wk with n_dk, n_wk with n_k."""
    from repro_torch.kernels import delta_push

    r, zo, zn, changed, d = batch
    out, ndk, nk = tables
    none = torch.zeros_like(changed)
    variants = {
        "streams_only": lambda: delta_push.delta_push_cuda(
            r, zo, zn, none, out, docs=d, ndk_out=ndk, nk_out=nk),
        "n_wk": lambda: delta_push.delta_push_cuda(r, zo, zn, changed, out),
        "n_wk_n_dk": lambda: delta_push.delta_push_cuda(
            r, zo, zn, changed, out, docs=d, ndk_out=ndk),
        "n_wk_n_k": lambda: delta_push.delta_push_cuda(
            r, zo, zn, changed, out, nk_out=nk),
    }
    return {name: timer.ms(fn, reps=reps) for name, fn in variants.items()}


def merge_rows(torch, timer: Timer, train: dict, groups: dict,
               card: str) -> list:
    """delta_push's merge form at each executor's group: held bitwise
    against its plain version in all three tables, timed warm back to back
    (and by destination, ``merge_by_destination``), and reported as its own
    row with the launches of that executor's run.
    Bytes: ``merge_bytes``.  No single PyTorch
    call writes three tables: library_ms is null."""
    rows = []
    for executor, reps, plain_reps in (("snapshot", 100, 10),
                                       ("pipelined", 20, 3)):
        batch = merge_batch(groups, executor)
        tables = group_tables(torch, train, executor)
        want = [x.clone() for x in tables]
        merge_ref(torch, batch, want)
        got = [x.clone() for x in tables]
        merge_cuda(torch, batch, got)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"delta_push's merge differs from its plain "
                                 f"version at the {executor} executor's "
                                 f"group")
        del got, want
        nbytes, sectors = merge_bytes(torch, batch, tables)
        ms = timer.ms(lambda: merge_cuda(torch, batch, tables), reps=reps)
        by_dest = merge_by_destination(torch, timer, batch, tables, reps)
        plain_ms = timer.ms(lambda: merge_ref(torch, batch, tables),
                            reps=plain_reps, device_only=False)
        t, n_changed = batch[0].shape[0], int(batch[3].sum())
        name = f"delta_push_train_{executor}"
        rows.append(kernel_row(
            name, "src/repro_torch/kernels/csrc/delta_push.cu",
            "src/repro/kernels/delta_push.py:39",
            train[f"{executor}_counts"]["delta_push"], 0.0, ms, plain_ms,
            nbytes, t * 4 + n_changed * 12))
        log(json.dumps({"timing": {name: {
            "tables": [list(x.shape) for x in tables], "tokens": t,
            "changed": n_changed, "sectors": sectors, "ms": ms,
            "by_destination_ms": by_dest, "bitwise": True, "card": card}}}))
        del batch, tables
    return rows


def routed_push(torch, train: dict, groups: dict, card: str) -> dict:
    """The message path: the trained state's n_wk handle pushes one
    snapshot group's reassignments through ``MatrixHandle.push`` with
    ``HybridRoute(HOT_WORDS)`` -- the hot [H, K] block by delta_push's
    single-destination form, the cold tail's COO buffer by
    delta_apply_coo, one launch each.  The pushed table equals the
    one-launch merge's bitwise.  Returns the push's launch counts."""
    from repro_torch import ps
    from repro_torch.kernels import ops

    st = train["state"]
    w, words, _, z0, z_new, changed = groups["snapshot"]
    handle = st.nwk.with_route(ps.HybridRoute(hot_words=HOT_WORDS))
    re = ps.Reassign(w, words, z0, z_new, changed)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    pushed = handle.push(re)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    if counts["delta_push"] != 1 or counts["delta_apply_coo"] != 1:
        raise AssertionError(f"the routed push launched {counts}, expected "
                             f"one delta_push and one delta_apply_coo")
    tables = group_tables(torch, train, "snapshot")
    merge_cuda(torch, merge_batch(groups, "snapshot"), tables)
    equal = bool(torch.equal(pushed.to_dense(), tables[0]))
    log(json.dumps({"push": {
        "route": repr(handle.route), "tokens": int(w.shape[0]),
        "changed": int(changed.sum()),
        "hot_changed": int((changed & (words < HOT_WORDS)).sum()),
        "launches": counts, "table_equals_merge": equal, "card": card}}))
    if not equal:
        raise AssertionError("the routed push's table differs from the "
                             "one-launch merge's")
    return counts


@dataclasses.dataclass(frozen=True)
class IdentityBackend:
    """Collective moments that are the identity, as the in-process
    backend's are, in a type that is not it: an executor on this backend
    takes the routed merge (route plan, backend moments, token_deltas)."""

    axis_name = None
    model_axis = None

    def pull_full(self, storage):
        return storage

    def reduce(self, delta):
        return delta

    def gather_concat(self, x):
        return x

    def localize(self, full):
        return full


def merge_compare(torch, timer: Timer, train: dict, groups: dict,
                  card: str) -> None:
    """The whole merge of one group, routed (the executors' merge on a
    backend that is not the in-process one: ``routed_merge_snapshot``,
    ``routed_merge_block``) against the one-launch merge, at both executors'
    groups, on the same card in turns (routed, merged, merged, routed):
    device ms per group (CUDA events over back-to-back merges), launches
    per group (the profiler's device kernels, memsets and copies included)
    and host ms per group (host clock around one merge, synchronised before
    and after; the median of 10).  Both give the same tables bitwise."""
    from repro_torch import ps
    from repro_torch.train import async_exec

    k = train["cfg"].K
    route = ps.HybridRoute(hot_words=HOT_WORDS)
    for executor, reps_old, reps_new in (("snapshot", 5, 100),
                                         ("pipelined", 2, 20)):
        batch = merge_batch(groups, executor)
        words = groups[executor][1]
        old_tables = group_tables(torch, train, executor)
        new_tables = [x.clone() for x in old_tables]

        def old():
            rows, z0, z_new, changed, docs = batch
            out, ndk, nk = old_tables
            if executor == "snapshot":
                nk, ndk = async_exec.routed_merge_snapshot(
                    route, IdentityBackend(), out, nk, ndk, rows, docs, z0,
                    z_new, changed, k)
            else:
                out, nk, ndk = async_exec.routed_merge_block(
                    route, out, nk, ndk, rows, words, docs, z0, z_new,
                    changed, k)
            return out, ndk, nk

        def new():
            merge_cuda(torch, batch, new_tables)
            return new_tables

        if not all(torch.equal(a, b) for a, b in zip(old(), new())):
            raise AssertionError(f"the routed and the one-launch merge "
                                 f"differ at the {executor} executor's group")
        seen = {"routed": {}, "one_launch": {}}
        for name in ("routed", "one_launch", "one_launch", "routed"):
            fn, reps = ((old, reps_old) if name == "routed"
                        else (new, reps_new))
            host = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            _, busy_ms, stats = device_profile(
                torch, lambda: [fn() for _ in range(reps_old)])
            for key, val in (
                    ("device_ms", timer.ms(fn, reps=reps)),
                    ("host_ms", float(np.median(host))),
                    ("launches", sum(n for n, _ in stats.values())
                     / reps_old),
                    ("profiled_device_ms", busy_ms / reps_old)):
                seen[name].setdefault(key, []).append(val)
        log(json.dumps({"merge_compare": {
            "executor": executor, "tokens": int(batch[0].shape[0]),
            "changed": int(batch[3].sum()), **seen, "card": card}}))
        del old_tables, new_tables


def sweep_compare(torch, train: dict, card: str) -> None:
    """One pipelined sweep from the trained state with the routed merge
    (the state's n_wk handle on ``IdentityBackend``) and one with the
    one-launch merge, each under the profiler: wall ms (host clock around
    the sweep, closed by a device synchronise), device busy ms and device
    kernels, and a profile of each in
    ``chiprun_out/pipelined_{routed,one_launch}_profile.txt``.  Both give
    the same z and count tables bitwise."""
    from repro_torch import ps
    from repro_torch import rng as jrng
    from repro_torch.train import async_exec

    st, cfg = train["state"], train["cfg"]
    client = st.nwk.client.with_backend(IdentityBackend())
    routed = st._replace(nwk=dataclasses.replace(st.nwk, client=client))
    step, _ = async_exec.make_executor(st, cfg, async_exec.ExecConfig(
        model_blocks=PIPE_BLOCKS, staleness=PIPE_STALENESS,
        route=ps.HybridRoute(hot_words=HOT_WORDS)))
    outs, profiled = {}, {}
    for name, state in (("routed", routed), ("one_launch", st)):
        def sweep():
            out = step.raw(state, jrng.PRNGKey(23, "cuda"))
            outs[name] = (out.z, out.nk.value, out.ndk, out.nwk.to_dense())

        wall_ms, busy_ms, stats = device_profile(torch, sweep)
        profiled[name] = {
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_kernels": sum(n for n, _ in stats.values())}
        (ROOT / "chiprun_out" / f"pipelined_{name}_profile.txt").write_text(
            f"{card}\none pipelined sweep, {name} merge, wall "
            f"{wall_ms:.3f} ms (profiler on), device busy {busy_ms:.3f} ms"
            f"\n\n{profile_table(stats)}\n")
    equal = all(torch.equal(a, b) for a, b in zip(outs["routed"],
                                                 outs["one_launch"]))
    if not equal:
        raise AssertionError("the pipelined sweep differs between the "
                             "routed and the one-launch merge")
    log(json.dumps({"sweep_compare": {
        "executor": "pipelined", "tokens": int(st.valid.sum()),
        "equal": equal, "profiled": profiled, "card": card}}))


def alias_row(torch, timer: Timer, name: str, weights, launches: int,
              reps: int, card: str) -> dict:
    """alias_build at ``weights``: held bitwise against its plain version,
    timed cold (each caller has just written the weights: serving's
    phi_from_counts, the executors' (n_wk + β)/(n_k + Vβ)), and its row."""
    from repro_torch.kernels import alias_build, ref

    v, k = weights.shape
    err = alias_bitwise(torch, alias_build.alias_build_cuda(weights),
                        ref.alias_build_ref(weights), name)
    ms = timer.ms(lambda: alias_build.alias_build_cuda(weights), reps=reps,
                  before=timer.evict)
    plain_ms = timer.ms(lambda: ref.alias_build_ref(weights), reps=1,
                        device_only=False, before=timer.evict)
    warps, rows_per_sm = alias_build.launch_config(k)
    log(json.dumps({"timing": {name: {
        "rows": v, "K": k, "bitwise": True, "ms": ms, "plain_ms": plain_ms,
        "warps_per_block": warps, "rows_per_sm": rows_per_sm,
        "card": card}}}))
    return kernel_row(name, "src/repro_torch/kernels/csrc/alias_build.cu",
                      "src/repro/kernels/alias_build.py:38", launches, err,
                      ms, plain_ms, v * k * 12, v * k * 10)


def training_alias_rows(torch, timer: Timer, train: dict,
                        card: str) -> list:
    """alias_build at each executor's weights of a sweep of the trained
    state: the snapshot's [V, K] table and the pipelined executor's first
    group of rows, each with the launches of that executor's run."""
    from repro_torch.train import async_exec

    st, cfg = train["state"], train["cfg"]
    snap_w = async_exec._weights(st.nwk.to_dense(), st.nk.value, cfg)
    rows = [alias_row(torch, timer, "alias_build_train_snapshot", snap_w,
                      train["snapshot_counts"]["alias_build"], 5, card)]
    del snap_w
    _, pulled = pipelined_group_rows(train)
    pipe_w = async_exec._weights(pulled, st.nk.value, cfg)
    rows.append(alias_row(torch, timer, "alias_build_train_pipelined",
                          pipe_w, train["pipelined_counts"]["alias_build"],
                          10, card))
    return rows


def kernel_report(torch, timer: Timer, serve: dict, train: dict,
                  card: str) -> list:
    from repro_torch.kernels import mh_sample, ref

    model = serve["model"]
    cfg = model.cfg
    rows = []

    args = main_path_mh_inputs(torch, model, serve["docs"], serve["seeds"])
    t, s = args[1].shape[0], cfg.mh_steps
    got = mh_sample.mh_sample_cuda(*args, cfg, frozen=True)
    want = ref.mh_sample_ref(*args, cfg, frozen=True)
    err = int((got - want).abs().max())
    if err:
        raise AssertionError("mh_sample differs from its plain version at "
                             "the main path's shapes")
    # Back to back, as the main path runs it: a batch's sweeps read the
    # same table sectors, and the profile below reads its launches at about
    # the warm time, so the tables stay in the L2 between sweeps.
    def kernel():
        mh_sample.mh_sample_cuda(*args, cfg, frozen=True)

    ms = timer.ms(kernel, reps=30)
    log(json.dumps({"timing": {"mh_sample": {
        "warm_ms": ms, "cold_ms": timer.ms(kernel, reps=30,
                                           before=timer.evict),
        "card": card}}}))
    plain_ms = timer.ms(lambda: ref.mh_sample_ref(*args, cfg, frozen=True),
                        reps=3, device_only=False)
    nbytes = mh_sample_bytes(torch, *args)
    flops = s * t * 60
    rows.append(kernel_row("mh_sample", "src/repro_torch/kernels/csrc/"
                           "mh_sample.cu", "src/repro/kernels/mh_sample.py:34",
                           serve["counts"]["mh_sample"], float(err), ms,
                           plain_ms, nbytes, flops))
    del args, got, want

    # once per publish, after phi_from_counts wrote 400 MB: cold
    serve_alias = alias_row(torch, timer, "alias_build", model.snapshot.phi,
                            serve["counts"]["alias_build"], 5, card)
    train_rows, groups = training_mh_rows(torch, timer, train, card)
    push_counts = routed_push(torch, train, groups, card)
    return (rows + train_rows + [serve_alias]
            + training_alias_rows(torch, timer, train, card)
            + merge_rows(torch, timer, train, groups, card)
            + delta_rows(torch, timer, train, groups, push_counts, card)), \
        groups


def draws_row(torch, timer: Timer, name: str, kernel, plain, launches: int,
              nbytes: int, hashes: int, reps: int, plain_reps: int,
              card: str) -> dict:
    """One mh_draws row: the kernel held bitwise against its plain version
    on the same inputs, both timed, the bound from ``hashes`` threefry
    hashes at the int32 rate or ``nbytes``, whichever is larger."""
    got, want = kernel(), plain()
    if not draws_match(torch, got, want):
        raise AssertionError(f"{name} differs from its plain version at the "
                             f"main path's shapes")
    slots = got.u_word.shape[1]
    del got, want
    ms = timer.ms(kernel, reps=reps)
    plain_ms = timer.ms(plain, reps=plain_reps, device_only=False)
    log(json.dumps({"timing": {name: {
        "slots": slots, "hashes": hashes, "bytes": nbytes, "bitwise": True,
        "ms": ms, "plain_ms": plain_ms, "card": card}}}))
    # no PyTorch call computes jax's threefry (torch.rand is Philox)
    return kernel_row(name, "src/repro_torch/kernels/csrc/mh_draws.cu",
                      "none: XLA fuses these draws outside Pallas",
                      launches, 0.0, ms, plain_ms, nbytes,
                      hashes * HASH_OPS, ops_rate=INT32_OPS)


def train_draws_work(torch, key, d_b, doc_start, doc_len, batch: int, cfg):
    """(bytes, hashes) one training draw needs on these inputs: the four
    [S, B] outputs written, d_b read, each distinct document's start and
    length read, z read where the doc proposal takes the token branch (its
    use_tok coin, recomputed here), the key; seven hashes an element, four
    for split(key, 4) and six a step for the step keys."""
    from repro_torch import rng as jrng
    from repro_torch.kernels import mh_draws

    steps = cfg.mh_steps
    kd = jrng.split(key, 4)[2]
    k3 = jrng.split(jrng.split(kd, steps), 3)[:, 2]
    nd = doc_len[d_b.long()].to(torch.float32)
    u3 = jrng.uniform(k3, batch)
    tok = int((u3 * (nd + mh_draws.k_alpha(cfg)) < nd).sum())
    docs = int(torch.unique(d_b).numel())
    nbytes = 16 * steps * batch + 4 * batch + 8 * docs + 4 * tok + 16
    return nbytes, 7 * steps * batch + 4 + 6 * steps


def mh_draws_rows(torch, timer: Timer, serve: dict, train: dict,
                  tiered: dict, card: str) -> list:
    """mh_draws at the main paths' shapes, each with its launches there:
    the training entry point at the snapshot executor's first group, the
    pipelined executor's first group and the tiered run's first block; the
    fold-in entry point at serving's full batch, sweep 0."""
    from repro_torch import rng as jrng
    from repro_torch.core import lightlda as lda
    from repro_torch.infer.foldin import pack_docs
    from repro_torch.kernels import mh_draws, ref

    st, cfg = train["state"], train["cfg"]
    key = jrng.PRNGKey(7, "cuda")
    g = cfg.block_tokens
    grp_rows, _ = pipelined_group_rows(train)
    idx, _ = lda.block_token_index(st.w.cpu().numpy(), st.valid.cpu().numpy(),
                                   grp_rows, st.nwk.layout)
    i = torch.from_numpy(idx[0]).to("cuda").long()
    tables = (st.z, st.doc_start, st.doc_len)
    tb = tiered["block"]["draws"]        # d_b, z, doc_start, doc_len, cap
    cases = (("mh_draws_train_snapshot", (st.d[:g], *tables, g), cfg,
              train["snapshot_counts"], 100, 5),
             ("mh_draws_train_pipelined", (st.d[i], *tables, i.shape[0]),
              cfg, train["pipelined_counts"], 10, 1),
             ("mh_draws_train_tiered", tb, tiered["cfg"], tiered["counts"],
              10, 1))
    rows = []
    for name, inputs, c, counts, reps, plain_reps in cases:
        args = (key, inputs[0].contiguous(), *inputs[1:])
        nbytes, hashes = train_draws_work(torch, key, args[1], args[3],
                                          args[4], args[5], c)
        rows.append(draws_row(
            torch, timer, name,
            lambda a=args, c=c: mh_draws.mh_draws_train_cuda(*a, c),
            lambda a=args, c=c: ref.mh_draws_train_ref(*a, c),
            counts["mh_draws_train"], nbytes, hashes, reps, plain_reps,
            card))

    model, docs, seeds = serve["model"], serve["docs"], serve["seeds"]
    eng, fcfg = model.engine(), model.cfg
    mb, bucket = eng.ecfg.max_batch, eng.ecfg.max_len
    pick = sorted(range(len(docs)), key=lambda j: -len(docs[j]))[:mb]
    _, valid = pack_docs([docs[j] for j in pick], bucket)
    keys = jrng.keys_from_seeds([seeds[j] for j in pick], "cuda")
    nd = torch.from_numpy(valid.sum(1).astype(np.int32)).to("cuda")
    z = jrng.randint(jrng.fold_in(keys, 0x1d4), (bucket,), 0, fcfg.K)
    b, steps = len(pick), fcfg.mh_steps
    sub = jrng.split(jrng.fold_in(keys, 0), 4)[:, 2]
    u3 = jrng.uniform(jrng.split(sub, 3)[:, 2], (steps, bucket))
    ndf = nd.to(torch.float32)[:, None, None]
    tok = int((u3 * (ndf + mh_draws.k_alpha(fcfg)) < ndf).sum())
    rows.append(draws_row(
        torch, timer, "mh_draws_foldin",
        lambda: mh_draws.mh_draws_foldin_cuda(keys, 0, z, nd, fcfg),
        lambda: ref.mh_draws_foldin_ref(keys, 0, z, nd, fcfg),
        serve["counts"]["mh_draws_foldin"],
        16 * steps * b * bucket + 20 * b + 4 * tok,
        7 * steps * b * bucket + 10 * b, 100, 5, card))
    return rows


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               flops, library_ms=None, ops_rate=FP32_FLOPS) -> dict:
    # the delta kernels' integer operations are held to the fp32 rate (the
    # data sheet gives no int32 rate outside the tensor cores); their byte
    # bound is far above it.  mh_draws, all int32 arithmetic, passes the
    # int32 lanes' rate (INT32_OPS)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_rate * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def device_profile(torch, fn):
    """Run ``fn`` under ``torch.profiler`` recording the card's activity
    only (kernels, copies, fills); returns ``(wall ms, device busy ms,
    {name: [launches, device ms]})``.  The profiler's raw events are read
    directly: building its per-event Python objects (``key_averages``)
    takes minutes for a training sweep's 1.6 M launches.

    The profiler drops the first device events of a session: none early
    in a process, then more the longer the process has run, however long
    the host waits around the work.  Such a loss cost a sweep its single
    alias_build launch.  So the session opens with ``lead`` tiny launches
    that are there to be dropped (how many were is logged), ``fn`` runs
    between two marker kernels (``torch.cuda._sleep``), only the events
    launched between the markers count (by correlation id), and a profile
    that lacks a marker is taken again with four times the lead (256 to
    16,384 launches)."""
    cuda = torch.autograd.DeviceType.CUDA
    lead = 256
    scratch = torch.zeros(1, device="cuda")
    for attempt in range(1, 5):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(lead):
                scratch.add_(1)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        marks = sorted(e.correlation_id() for e in events
                       if "spin_kernel" in e.name())
        if len(marks) == 2:
            kept = sum(1 for e in events if e.correlation_id() < marks[0])
            if kept < lead:
                log(json.dumps({"profile_dropped_lead": {
                    "lead": lead, "dropped": lead - kept}}))
            break
        log(json.dumps({"profile_lost_a_marker": {
            "attempt": attempt, "lead": lead, "markers": len(marks),
            "device_events": len(events)}}))
        lead *= 4
    else:
        raise AssertionError(f"the profile lost a marker kernel in "
                             f"{attempt} attempts")
    stats = {}
    for e in events:
        if marks[0] < e.correlation_id() < marks[1]:
            s = stats.setdefault(e.name(), [0, 0.0])
            s[0] += 1
            s[1] += e.duration_ns() / 1e6
    return wall_ms, sum(ms for _, ms in stats.values()), stats


def profile_table(stats: dict, rows: int = 30) -> str:
    busy = sum(ms for _, ms in stats.values()) or 1.0
    top = sorted(stats.items(), key=lambda kv: -kv[1][1])[:rows]
    lines = [f"{'device ms':>12} {'share':>7} {'launches':>9}  kernel"]
    lines += [f"{ms:12.3f} {ms / busy:7.2%} {n:9d}  {name[:100]}"
              for name, (n, ms) in top]
    return "\n".join(lines)


def of_kernel(stats: dict, name: str) -> dict:
    hit = [v for k, v in stats.items() if name in k]
    return {"count": sum(n for n, _ in hit),
            "device_ms": sum(ms for _, ms in hit)}


def eager_key_ops(torch, card: str) -> dict:
    """The tensor operations of the key derivations that stay eager (each
    an operation PyTorch dispatches on the card; views not counted):
    ``split(key, 244)`` a snapshot sweep, ``stream_sweep_key`` a stream or
    net visit, the fold-in init draw of a [32 x 1024] batch, and a stream
    shard's init draw of 262,144 tokens."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import rng as jrng
    from repro_torch.api.session import stream_init_key, stream_sweep_key

    views = {"view", "_unsafe_view", "reshape", "expand", "select", "slice",
             "unsqueeze", "squeeze", "t", "transpose", "as_strided",
             "alias", "detach", "lift_fresh"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in views:
                self.n += 1
            return func(*args, **(kwargs or {}))

    key = jrng.PRNGKey(3, "cuda")
    keys = jrng.keys_from_seeds(range(32), "cuda")
    out = {}
    for name, fn in (
            ("split_per_sweep", lambda: jrng.split(key, 244)),
            ("stream_sweep_key_per_visit",
             lambda: stream_sweep_key(0, 1, 3, "cuda")),
            ("foldin_init_draw_per_batch",
             lambda: jrng.randint(jrng.fold_in(keys, 0x1d4), (1024,), 0,
                                  K_FULL)),
            ("stream_init_draw_per_shard",
             lambda: jrng.randint(stream_init_key(0, 5, "cuda"),
                                  (STREAM_SHARD_TOKENS,), 0, K_FULL))):
        with Count() as c:
            fn()
        out[name] = c.n
    log(json.dumps({"eager_key_ops": dict(out, card=card)}))
    return out


def profile_batch(torch, serve: dict, card: str) -> None:
    """Device time by kernel over one full fold-in batch, and the device's
    busy share of the batch's wall time."""
    from repro_torch.infer.foldin import fold_in_batch, pack_docs
    from repro_torch import rng as jrng

    model, docs, seeds = serve["model"], serve["docs"], serve["seeds"]
    eng = model.engine()
    mb, bucket = eng.ecfg.max_batch, eng.ecfg.max_len
    pick = sorted(range(len(docs)), key=lambda j: -len(docs[j]))[:mb]
    w, valid = pack_docs([docs[j] for j in pick], bucket)
    w = torch.from_numpy(w).cuda()
    valid = torch.from_numpy(valid).cuda()
    keys = jrng.keys_from_seeds([seeds[j] for j in pick], "cuda")
    snap = model.snapshot
    wall_ms, busy_ms, stats = device_profile(torch, lambda: fold_in_batch(
        snap.model, w, valid, keys, snap.cfg, eng.ecfg.foldin))
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "serving_profile.txt").write_text(
        f"{card}\none fold-in batch [{mb} x {bucket}], wall {wall_ms:.3f} ms "
        f"(profiler on), device busy {busy_ms:.3f} ms\n\n"
        f"{profile_table(stats)}\n")
    mh = of_kernel(stats, "mh_sample")
    draws = of_kernel(stats, "mh_draws_foldin")
    if not busy_ms or not mh["count"] or not draws["count"]:
        raise AssertionError("the profile of a fold-in batch shows no device "
                             "time, or no mh_sample or mh_draws_foldin "
                             "launch")
    log(json.dumps({"profile": {
        "batch": [mb, bucket], "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels": sum(n for n, _ in stats.values()),
        "launches_per_sweep": sum(n for n, _ in stats.values())
        / eng.ecfg.foldin.num_sweeps,
        "mh_sample_device_ms": mh["device_ms"],
        "mh_draws_foldin": draws, "card": card}}))


def profile_sweep(torch, train: dict, card: str) -> None:
    """One snapshot sweep of the trained state without the profiler (ms
    and tokens/s), then one under it: device time by kernel and the
    device's busy share of its wall time; and the host-timed parts of a
    sweep: the alias build (the kernel, and the plain version beside it),
    and per group the threefry draws, mh_sample, the one-launch merge the
    executor runs, and beside it the route's plan and token_deltas' [D, K]
    buffer, which the routed merge would run."""
    from repro_torch import ps
    from repro_torch import rng as jrng
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lightlda as lda
    from repro_torch.kernels import ops
    from repro_torch.train import async_exec

    st, cfg = train["state"], train["cfg"]
    route = ps.HybridRoute(hot_words=HOT_WORDS)
    tokens = int(st.valid.sum())

    def sweep():
        return async_exec.snapshot_sweep(st, jrng.PRNGKey(11, "cuda"), cfg,
                                         route=route)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    # A profile that lacks a kernel of the sweep between its markers (the
    # profiler lost device events under the floods of launches that sweeps
    # made before the draws' repair) is taken again, three times at most.
    kernels = ("mh_draws_train_kernel", "mh_sample_kernel",
               "delta_push_kernel", "alias_build_kernel")
    for attempt in range(1, 4):
        wall_ms, busy_ms, stats = device_profile(torch, sweep)
        missing = [n for n in kernels if not of_kernel(stats, n)["count"]]
        if not missing:
            break
        log(json.dumps({"profile_training_incomplete": {
            "attempt": attempt, "missing": missing}}))
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "training_profile.txt").write_text(
        f"{card}\none snapshot sweep, V={cfg.V} K={cfg.K}, "
        f"{int(st.valid.sum())} tokens, wall {wall_ms:.3f} ms (profiler "
        f"on), device busy {busy_ms:.3f} ms\n\n{profile_table(stats)}\n")
    if missing:
        raise AssertionError(
            f"the profile of a training sweep shows no {missing} launch in "
            f"{attempt} attempts; it shows "
            f"{ {n: of_kernel(stats, n)['count'] for n in kernels} }")
    by_kernel = {name: of_kernel(stats, name) for name in kernels}
    if not busy_ms:
        raise AssertionError("the profile of a training sweep shows no "
                             "device time")

    # host clock around synchronised parts, profiler off
    def timed(fn, reps=1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / reps, out

    g = cfg.block_tokens
    groups = st.w.shape[0] // g
    nwk_dense, nk = st.nwk.to_dense(), st.nk.value
    weights = async_exec._weights(nwk_dense, nk, cfg)
    alias_ms, tbl = timed(lambda: ops.alias_build(weights), reps=3)
    alias_plain_ms, _ = timed(lambda: alias_mod.build_alias_rows(weights))
    w_b, d_b, valid_b = st.w[:g], st.d[:g], st.valid[:g]
    z0 = st.z[:g].clone()
    key = jrng.PRNGKey(3, "cuda")
    draw_ms, rng = timed(lambda: ops.mh_draws_train(
        key, d_b, st.z, st.doc_start, st.doc_len, g, cfg), reps=5)
    draw_plain_ms, _ = timed(lambda: lda.draw_mh_randoms(
        key, lda.make_doc_draw(d_b, st.z, st.doc_start, st.doc_len, cfg), g,
        cfg), reps=5)
    nwk_f = nwk_dense.to(torch.float32)
    nk_f = nk.to(torch.float32)
    mh_ms, z_new = timed(lambda: ops.mh_sample(
        rng, z0, w_b, d_b, nwk_f, st.ndk, nk_f, tbl.prob, tbl.alias, cfg),
        reps=5)
    changed = (z_new != z0) & valid_b
    re = ps.Reassign(w_b, w_b, z0, z_new, changed)
    plan_ms, _ = timed(lambda: route.plan(re, cfg.V, cfg.K,
                                          prefix_rows=True), reps=5)
    deltas_ms, _ = timed(lambda: async_exec.token_deltas(
        d_b, z0, z_new, changed, st.ndk.shape[0], cfg.K), reps=5)
    ndk, nk_own = st.ndk.clone(), nk.clone()
    merge_ms, _ = timed(lambda: ops.delta_push(
        w_b, z0, z_new, changed, cfg.V, cfg.K, out=nwk_dense, docs=d_b,
        ndk_out=ndk, nk_out=nk_own), reps=5)
    log(json.dumps({"profile_training": {
        "executor": "snapshot", "tokens": tokens, "sweep_ms": sweep_ms,
        "tokens_per_s": tokens / (sweep_ms / 1e3),
        "wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels": sum(n for n, _ in stats.values()),
        "launches_per_group": sum(n for n, _ in stats.values()) / groups,
        "kernels": by_kernel,
        "groups": groups, "alias_build_ms_per_sweep": alias_ms,
        "alias_build_plain_ms_per_sweep": alias_plain_ms,
        "per_group_ms": {"threefry_draws": draw_ms,
                         "threefry_draws_plain": draw_plain_ms,
                         "mh_sample": mh_ms,
                         "merge": merge_ms, "route_plan": plan_ms,
                         "token_deltas": deltas_ms},
        "card": card}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)

    t0 = time.perf_counter()
    logs = _build.build(_build.SOURCES, ptxas_info=True)
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log(f"[phase] {name} {time.perf_counter() - t:.1f} s")
        return out

    phase("check_kernels", check_kernels, torch)
    phase("check_delta_kernels", check_delta_kernels, torch)
    phase("check_draws", check_draws, torch)
    serve = phase("serve", serve_slice, torch, args.seed, card)
    train = phase("train", train_slice, torch, args.seed, card)
    phase("card_vs_cpu", card_vs_cpu, torch, args.seed)
    stream = phase("stream_train", stream_train, torch, args.seed, card,
                   train["corpus"])
    phase("stream_card_vs_cpu", stream_card_vs_cpu, torch, args.seed, card)
    phase("service", service, torch, args.seed, card, train["corpus"],
          serve["docs"])
    phase("launchers", launchers, torch, card)
    tiered = phase("tiered_train", tiered_train, torch, args.seed, card,
                   train["corpus"])
    phase("tiered_card_vs_cpu", tiered_card_vs_cpu, torch, args.seed, card,
          train)
    phase("autotune", autotune_fit, torch, args.seed, card, train["corpus"])
    phase("net", net_train, torch, args.seed, card, train["corpus"],
          "cuda", V_FULL, K_FULL, STREAM_SHARD_TOKENS, 8192,
          stream.pop("snapshot_final"))
    timer = Timer(torch)
    rows, groups = phase("kernel_report", kernel_report, torch, timer, serve,
                         train, card)
    rows += phase("tiered_kernels", tiered_kernel_rows, torch, timer, tiered,
                  card)
    rows += phase("draws_kernels", mh_draws_rows, torch, timer, serve, train,
                  tiered, card)
    phase("merge_compare", merge_compare, torch, timer, train, groups, card)
    phase("sweep_compare", sweep_compare, torch, train, card)
    phase("profile_batch", profile_batch, torch, serve, card)
    phase("eager_key_ops", eager_key_ops, torch, card)
    phase("profile_sweep", profile_sweep, torch, train, card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
