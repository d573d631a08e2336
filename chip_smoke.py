#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, network-PS and SPMD paths,
the LM serving and training paths, LM serving and training on a device
mesh, the Spark-LDA baselines and the traced executor replay on one
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
                 [32 x 1024] batch, sweeps 0 and 29; its two threefry
                 entry points bitwise against rng's plain functions:
                 threefry_keys at split(key, 244), split(keys, 2) of 32
                 keys and the stream keys' fold-in chains,
                 threefry_randint at serving's [32 x 1024] init draw
                 (fold_in 0x1d4 folded in) at K in {7, 130, 1000} and a
                 stream shard's 262,144 tokens;
  3b. lm_mesh -- LM serving on a device mesh of 4 gloo rank processes
                 sharing the card (serve.mesh_worker), run first while
                 the card is empty: deepseek-v2-lite-16b at its full
                 config (27 layers, MLA, 64 experts top-6, bf16, 15.72 B
                 parameters from --seed) on data 1 x model 4, batch 4,
                 prompt 2,048, 8 greedy tokens at capacity factor 1.25:
                 (a) at capacity factor 16 (no drops, asserted) the
                 prefill's and 8 teacher-forced decode steps' logits
                 against the single-device run of the same seed after
                 the mesh has gone, held within 1/32 of the row's largest
                 logit in float32, reported in bf16; (b) the first MoE
                 layer at the cell's shape on every rank against
                 moe_block_spmd_emulated (routed rows within 2^-7, the
                 output within 2^-5, drops equal); prefill and decode ms,
                 tokens/s, each rank's peak memory, the collectives' ms
                 and bytes by kind and their share, the dropped share by
                 layer, the byte and FLOP bounds in a {"lm_mesh_serve":
                 ...} line; then gemma3-4b at full width, 6 layers, on
                 data 2 x model 2 through repro_torch.launch.serve --mesh
                 host (its timed parts of Engine.generate), its logits against one device within 1/32, and the
                 eight attention archs' smoke variants against one
                 device on the card, in a {"lm_mesh_dp": ...} line;
  3c. lm_mesh_train -- LM training on a data 2 x model 2 mesh of 4 gloo
                 ranks sharing the card (train.mesh_worker): (a)
                 deepseek-v2-lite-16b at full width, 3 layers, float32,
                 4 x 128, microbatch 2, capacity factor 16 (no pair
                 dropped, asserted): one step's loss, gradient (ZeRO
                 slices gathered), moments and parameters against the
                 single device's step of the same seed after the mesh
                 has gone; then bf16 cells from the seed, 4 x 2,048,
                 microbatch 2, remat: deepseek 3 layers (capacity factor
                 1.25, 2 steps) and gemma3-4b 6 layers (2 steps): (b)
                 finite losses and grad norms, every rank's parameter
                 and moment blocks moved; step ms, tokens/s, peak memory
                 a rank, the collectives by tag and their share, the
                 dropped share and the FLOP-plus-AdamW-bytes bound; (c)
                 the eight attention archs' smoke variants' step on the
                 mesh against one device on the card; a
                 {"lm_mesh_train": ...} line;
  3d. lm_mesh_ssm -- the SSM families on a model axis above 1: (a)
                 mamba2-370m at its full config served on data 1 x model
                 4 through repro_torch.launch.serve --mesh host (4 x
                 2,048, 8 greedy tokens) and trained on 2 x 2 through
                 repro_torch.launch.train --mesh host (4 layers, 4 x
                 2,048, microbatch 2, 2 steps); (b) hymba-1.5b at full
                 width on 2 x 2 ("heads" SSM, "gather" attention), served
                 at 4 layers and trained at 2; (c) mamba2-370m in
                 float32 on 1 x 4 against one device: logits within
                 1/32 of the row's largest, one train step at (3c)'s
                 check (a) tolerances; a {"lm_mesh_ssm": ...} line;
  3e. lm_mesh_long -- the sequence-sharded decode cache, batch 1 on 2 x
                 2: gemma3-4b at full width, 6 layers, and hymba-1.5b at
                 2 layers, a 32,768-slot cache, a 24,576-token prompt, 16
                 greedy tokens; (f) gemma3-4b in float32 at 8,192 slots
                 against one device within 1/32, every data rank's
                 logits the same bits; a {"lm_mesh_long": ...} line;
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
                 equal the stream plane's bitwise), two workers for 1
                 epoch (exact conservation against the z files'
                 histogram, falling perplexity, each worker's own launch
                 counters: one
                 mh_draws_train, mh_sample and delta_push a group and one
                 alias_build a visit); tokens/s, the per-visit split and
                 the server's commit ms; repro_torch.launch.net_smoke
                 --device cuda --workers 2 (faults, a SIGKILL) exits 0; a
                 1-worker job at V = 3,000, K = 64 on the card and on the
                 CPU, counts and z files equal bitwise;
 13. spmd     -- the SPMD parameter server (torch.distributed): 4 ranks
                 sharing the card over gloo, mesh 2 x 2, on the training
                 corpus with HybridRoute(2000): APSLDA(LDAJob(...,
                 backend="spmd", mesh_model=2), devices=4) for 3 sweeps
                 (exact conservation of the gathered state, falling
                 perplexity, each rank's launches -- one mh_draws_train,
                 mh_sample, delta_push and delta_apply_coo a group,
                 alias_build once a sweep -- its peak device memory and
                 ms per sweep split into the pull's all-gather, the group
                 collectives and the rest); the streamed SPMD plane on
                 stream_train's shards, 2 epochs (conservation against the
                 z files after each epoch, read through the view); one
                 rank on NCCL for one sweep, equal bitwise to the same
                 rank on gloo; and at V = 3,000, K = 64 the memory and
                 stream planes with the dense, hybrid and COO routes on 4
                 ranks on the card equal to 4 ranks on the CPU bitwise;
 14. lm_serve -- the LM serving path at gemma3-4b's full width and depth
                 (34 layers, d_model 2,560, vocab 262,144, bf16, weights
                 drawn from --seed on the card) through
                 repro_torch.launch.serve's main: batch 4, prompt 2,048,
                 64 greedy tokens; the output's shape and range, a
                 second generate equal to the first, a timed prefill and
                 decode loop equal to generate, the first 8 decode steps'
                 logits against one full-sequence forward (within
                 LM_BF16_TOL of the row's largest logit), one decode step
                 under the profiler (device busy share, kernels), peak
                 memory, and the decode (bytes) and prefill (FLOPs)
                 bounds in a {"lm_serve": ...} line; then every arch's
                 smoke variant (MLA, MoE, SSM, the hybrid, both
                 cross-attention modes) on the card against the CPU from
                 the same weights;
 15. lm_train -- the LM training path through repro_torch.launch.train's
                 main: lm100m (the JAX launcher's end-to-end preset,
                 100.7 M parameters, float32) for 50 steps of 8 x 256,
                 its loss falling by more than 0.5 and its final npz
                 (the JAX package's layout) equal to the model; gemma3-4b
                 at full width and depth (bf16, remat) for 6 steps of
                 2 x 2,048 with microbatch 2: finite losses and grad
                 norms, every parameter and moment moved; for each, step
                 ms against the FLOP and byte bounds, tokens/s, peak
                 memory, one step under the profiler (kernels, idle
                 share) and gemma3-4b's split (a microbatch's forward
                 and backward, the fold, AdamW) in a {"lm_train": ...}
                 line; then every arch's smoke variant's train step (and
                 gemma3-4b's with microbatch 2) on the card against the
                 CPU, and a bf16 attention step's backward (_bmm_f32)
                 against the widened operands' autograd;
 16. report   -- per-kernel times at the main paths' shapes (alias_build
                 held bitwise at serving's φ and at each executor's
                 weights; the merge at each executor's group, also by
                 destination; mh_draws at a snapshot group, a pipelined
                 group, a tiered block and a fold-in batch, threefry_keys
                 at a snapshot sweep's split and threefry_randint at
                 serving's and training's init draws; the SPMD path's
                 rows, delta_apply_coo at its gathered COO), the whole
                 merge of one group as the
                 executors composed it before (route plan, token_deltas,
                 adds) against the one-launch merge, in turns, then one
                 pipelined sweep taken each way; a
                 profile of one fold-in batch and of one training sweep,
                 the launches of the key derivations and init draws (at
                 most 2 each, asserted);
 17. baselines -- paper Table 1 on the card on the training corpus at
                 V = 100,000 for K in {80, 1000}: Spark-EM (10 iterations),
                 Spark-Online (30 minibatches of 128 documents, densified
                 off the clock) and LightLDA-PS (3 snapshot sweeps through
                 APSLDA; at K = 1,000 the training phase's run): perplexity
                 before and after (each must fall, or EM's sit at its
                 symmetric fixed point), runtime, tokens/s, the
                 shuffle model, peak device memory; EM's γ rows sum to 1
                 and its n_k to the tokens; then at tests/
                 test_lda_baselines.py's size EM and online VB on the card
                 within stated tolerances of the CPU from states drawn on
                 the CPU, and EM's perplexity within 15 % of LightLDA's;
 18. replay   -- obs.exec_trace's traced replay of a pipelined sweep (16
                 model blocks, staleness 1, HybridRoute(2000), 8 groups of
                 [12,500 x 1,000]) on the trained state under an obs
                 session: bitwise equal to the pipelined executor, one
                 mh_draws_train, alias_build and mh_sample a group and one
                 delta_push and delta_apply_coo (the route's dense and
                 coordinate parts) a group that holds a token, each phase
                 span's median ms,
                 and the trace rendered by launch.obs_report; its merge
                 kernels held bitwise and timed at a group's shapes;
 19. examples -- the six user examples' twins (examples/*_torch.py) at the
                 JAX examples' own sizes: quickstart and stream_train in
                 this process between reads of the launch counters
                 (mh_draws, mh_sample, alias_build and delta_push
                 launched; quickstart's counts equal the same main on the
                 CPU bitwise, its printed top words and best docs equal),
                 then serve_topics, lda_distributed (8 gloo ranks on the
                 card; its ranks' delta_push and delta_apply_coo launches
                 from launch.lda's counter line), serve_lm and train_lm
                 (--steps 50) as subprocesses, all at once, each checked
                 by its printed lines; an {"examples": ...} line; then
                 the JSON line of each kernel's launches, error, times
                 and bound, then the device line last.

The 2 x 2 LM mesh stays open from lm_mesh_dp's checks through
lm_mesh_train, and from lm_mesh_ssm's (b) through lm_mesh_long
(``MeshPool``).  Imports nothing of JAX or of the JAX package.  Writes
profiles to chiprun_out/serving_profile.txt and
chiprun_out/training_profile.txt, the training run's trace and metrics to
chiprun_out/train_obs/, the streamed
runs' to chiprun_out/stream_obs/, the service's to
chiprun_out/service_obs/, the tiered runs' to chiprun_out/tiered_obs/, the
Table 1 LightLDA run's to chiprun_out/baselines_obs/ and the replay's to
chiprun_out/replay_obs/; one tiered sweep runs under the profiler
(tiered_profile.txt), one LM decode step (lm_decode_profile.txt) and one
LM train step of each training cell (lm100m_train_profile.txt,
lm_train_profile.txt).  Stream
directories, checkpoints and cold stores go to temporary directories,
removed at exit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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


def check_threefry(torch) -> None:
    """mh_draws' threefry entry points against rng's plain functions on
    the card, bitwise: threefry_keys at a snapshot sweep's split(key, 244),
    split(keys, 2) of a [32 x 2] key batch and the stream keys' fold-in
    chains; threefry_randint at serving's [32 x 1024] init draw (fold_in
    0x1d4 folded in) at K in {7, 130, 1000} and a stream shard's 262,144
    tokens from stream_init_key's chain."""
    from repro_torch import rng as jrng
    from repro_torch.kernels import mh_draws, ref

    key = jrng.PRNGKey(7, "cuda")
    keys = jrng.keys_from_seeds(range(1000, 1032), "cuda")
    for what, kk, data, num in (("split", key, (), 244),
                                ("split", keys, (), 2),
                                ("fold_in", jrng.PRNGKey(0, "cuda"),
                                 (1, 3, 17), 0),
                                ("fold_in", keys, (0x1d4,), 0)):
        got = mh_draws.threefry_keys_cuda(kk, data, num)
        want = ref.threefry_keys_ref(kk, data, num)
        torch.cuda.synchronize()
        match = bool(torch.equal(got, want))
        log(json.dumps({"check": "threefry_keys", "what": what,
                        "keys": list(kk.shape[:-1]), "data": list(data),
                        "num": num, "match": match}))
        if not match:
            raise AssertionError(f"threefry_keys differs from rng's {what} "
                                 f"at {tuple(kk.shape)}, {data}, {num}")
    for kk, shape, k, data in ((keys, (1024,), 7, (0x1d4,)),
                               (keys, (1024,), 130, (0x1d4,)),
                               (keys, (1024,), K_FULL, (0x1d4,)),
                               (jrng.PRNGKey(0, "cuda"),
                                (STREAM_SHARD_TOKENS,), K_FULL, (0, 5))):
        got = mh_draws.threefry_randint_cuda(kk, shape, 0, k, data)
        want = ref.threefry_randint_ref(kk, shape, 0, k, data)
        torch.cuda.synchronize()
        match = bool(torch.equal(got, want))
        log(json.dumps({"check": "threefry_randint",
                        "shape": list(got.shape), "K": k,
                        "data": list(data), "match": match}))
        if not match:
            raise AssertionError(f"threefry_randint differs from rng's "
                                 f"randint at {tuple(got.shape)}, K={k}")


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
        inits = (transform_counts["threefry_randint"]
                 - publish_counts["threefry_randint"])
        if inits != batches:
            raise AssertionError(f"threefry_randint launched {inits} times "
                                 f"in transform, expected one a batch = "
                                 f"{batches}")
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


def lightlda_job(corp, v: int, k: int, seed: int, obs_dir: Path):
    """The training cell's job: the snapshot executor with
    HybridRoute(2000), 3 sweeps, perplexity after each, traced into
    ``obs_dir``."""
    from repro_torch.api import HybridRoute, LDAJob, ObsConfig

    return LDAJob(corpus=corp, num_topics=k, vocab_size=v,
                  route=HybridRoute(hot_words=HOT_WORDS), sweeps=3,
                  eval_every=1, seed=seed,
                  obs=ObsConfig(enabled=True, out_dir=str(obs_dir)))


def train_slice(torch, seed: int, card: str, device: str = "cuda",
                v: int = V_FULL, k: int = K_FULL,
                n_docs: int = TRAIN_DOCS) -> dict:
    """Train at (v, k) through APSLDA: the snapshot executor for 3 sweeps,
    then the pipelined executor for one; check each and serve the model.
    Launch counts are checked on the card only (the CPU runs the plain
    versions)."""
    from repro_torch.api import APSLDA, ObsConfig
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
    job = lightlda_job(corp, v, k, seed, obs_dir)
    out = {"corpus": corp, "job": job}

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
    check_key_launches(counts, "snapshot executor", device)
    conservation(torch, est.result_.state, "snapshot executor")
    ppl = [row["perplexity"] for row in model.history]
    if not (len(ppl) == 3 and ppl[2] < ppl[0]):
        raise AssertionError(f"perplexity did not fall: {ppl}")
    spans = sweep_spans(obs_dir / "trace.json")
    tokens = corp.num_tokens
    out.update(model=model, state=est.result_.state, cfg=model.cfg,
               snapshot_counts=counts, info=info, perplexity=ppl,
               sweep_ms=[a for a, _ in spans])
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
    check_key_launches(pcounts, "pipelined executor", device)
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
    """The kernels ``want`` names launched exactly so often (the threefry
    kernels' counts, which follow the schedule's keys, are logged beside
    them)."""
    got = {name: counts[name] for name in want}
    if device == "cuda" and got != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def check_key_launches(counts: dict, what: str, device: str) -> None:
    """A training run drew its keys (threefry_keys) and its initial
    assignments (threefry_randint) on the card."""
    if device == "cuda" and not (counts["threefry_keys"]
                                 and counts["threefry_randint"]):
        raise AssertionError(f"{what}: the threefry kernels were not "
                             f"launched: {counts}")


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
NET_EPOCHS = 1                  # the 2-worker run's (b)
NET_SMALL = (3000, 64)          # (d)'s V and K


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
              block_tokens: int = 8192,
              reference: Optional[dict] = None) -> dict:
    """Training through the network parameter server at (v, k) on ``corp``
    in shards of ``tokens_per_shard``, the job of stream_train's snapshot
    run (hot words 2,000, committed as the dense prefix; the same seed):

      (a) one worker, 2 epochs: n_wk, n_k and every z file equal the
          in-process stream plane's (``reference``: stream_train's result,
          or a run made here) bitwise;
      (b) two workers, 1 epoch (2 before the examples joined the
          script: its time, PERF.md section 4), dynamic leases, the
          perplexity taken after half the shard visits and after all:
          exact conservation (the server's counts are the z files'
          histogram, the token mass unchanged), the perplexity falling,
          and each worker's own launch counters: one mh_draws_train,
          mh_sample and delta_push a group and one alias_build a visit,
          on the card;
      (c) ``python -m repro_torch.launch.net_smoke --device <device>
          --workers 2``: faults on every op, one worker SIGKILLed; exit 0;
      (d) on the card only: a 1-worker job at NET_SMALL's (V, K) on the
          card and on the CPU, counts and z files bitwise equal (the CPU's
          job in a process of its own, ``--net-cpu``, beside (c)).

    Prints tokens/s with 1 and 2 workers (first granted lease to last
    commit), each worker's median host ms per part of a visit, the
    server's median ms to apply a commit, superseded commits, retries,
    reconnects and each worker's peak device memory."""
    import tempfile

    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data import stream
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
                                   workers=NET_WORKERS, epochs=NET_EPOCHS,
                                   eval_every=n_shards // 2)
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
                  == NET_EPOCHS * n_shards}
        two = net_summary(res.info, NET_EPOCHS * meta.num_tokens)
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

    # (d)'s CPU job beside (c)
    cpu_dir = tempfile.mkdtemp()
    cpu_proc = None
    if device == "cuda":
        with open(Path(cpu_dir) / "cpu.log", "w") as cpu_log:
            cpu_proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
                 str(seed), "--net-cpu", cpu_dir], cwd=str(ROOT),
                stdin=subprocess.DEVNULL, stdout=cpu_log,
                stderr=subprocess.STDOUT)
    try:
        # (c) the fault drill, as a user runs it
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.net_smoke", "--device",
             device, "--workers", "2"], capture_output=True, text=True,
            timeout=900, cwd=str(ROOT),
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        tail = proc.stdout.strip().splitlines()[-1:] or [""]
        out["net_smoke"] = {"rc": proc.returncode,
                            "s": time.perf_counter() - t0, "last": tail[0]}
        log(json.dumps({"net_smoke": dict(out["net_smoke"], card=card)}))
        if proc.returncode != 0:
            raise AssertionError(
                f"net_smoke failed (rc {proc.returncode}):\n"
                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")

        # (d) card against CPU at a small width
        if device == "cuda":
            small_v, small_k = NET_SMALL
            nwk, nk, z, tokens = net_small_run(seed, "cuda", small_v, small_k)
            if cpu_proc.wait(timeout=600) != 0:
                raise AssertionError(
                    f"the CPU's net job failed:\n"
                    f"{(Path(cpu_dir) / 'cpu.log').read_text()[-4000:]}")
            with np.load(Path(cpu_dir) / "net_cpu.npz") as ref:
                equal = {"nwk": bool(np.array_equal(nwk, ref["nwk"])),
                         "nk": bool(np.array_equal(nk, ref["nk"])),
                         "z_files": len(z) == len(ref.files) - 2 and all(
                             np.array_equal(a, ref[f"z{i}"])
                             for i, a in enumerate(z))}
            log(json.dumps({"check": "net_card_vs_cpu", "V": small_v,
                            "K": small_k, "tokens": tokens, "equal": equal}))
            if not all(equal.values()):
                raise AssertionError(f"net training on the card differs from "
                                     f"the CPU: {equal}")
    finally:
        if cpu_proc is not None and cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.wait(timeout=30)
        shutil.rmtree(cpu_dir, ignore_errors=True)
    return out


def net_small_run(seed: int, device: str, v: int, k: int) -> tuple:
    """net_train's (d): a 1-worker job at (v, k) on ``device``; its n_wk,
    n_k and z files as numpy."""
    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data.corpus import synthetic_corpus

    small = synthetic_corpus(300, v, true_topics=16, seed=seed)
    sjob = LDAJob(corpus=small, num_topics=k, vocab_size=v, backend="net",
                  workers=1, hot_words=200, sweeps=2, block_tokens=1024,
                  eval_every=0, seed=seed)
    est = APSLDA(sjob, log_fn=lambda m: None, device=device)
    est.fit()
    r = est.result_
    return (r.nwk.value.cpu().numpy(), r.nk.value.cpu().numpy(),
            [r.reader.read_z(s) for s in range(r.reader.num_shards)],
            small.num_tokens)


def net_cpu_run(seed: int, out_dir: str) -> None:
    """net_train's (d) on the CPU, saved to ``out_dir/net_cpu.npz``
    (``chip_smoke.py --net-cpu DIR``: a process of its own, so that it
    runs beside the card's work)."""
    nwk, nk, z, _ = net_small_run(seed, "cpu", *NET_SMALL)
    np.savez(Path(out_dir) / "net_cpu.npz", nwk=nwk, nk=nk,
             **{f"z{i}": a for i, a in enumerate(z)})


# -- phase 13: the SPMD parameter server ------------------------------------

SPMD_RANKS, SPMD_MODEL = 4, 2       # 4 ranks share the card: mesh 2 x 2


def spmd_expected(groups: int, alias_builds: int, coo: bool) -> dict:
    """One rank's launches on the SPMD path for ``groups`` groups: one
    mh_draws_train and mh_sample a group, delta_push once a group (the
    route's dense part: the hybrid's hot prefix) and, with a coordinate
    part, one delta_apply_coo a group (the gathered cold COO); alias_build
    ``alias_builds`` times (once a sweep or visit)."""
    return {"mh_sample": groups, "delta_push": groups,
            "delta_apply_coo": groups if coo else 0,
            "alias_build": alias_builds, "mh_draws_train": groups,
            "mh_draws_foldin": 0}


def spmd_ranks(info: dict, want: dict, what: str, device: str) -> list:
    """Each rank's launches against ``want``, and its split of a step's
    host ms: the pull's all-gather, the group collectives, the rest."""
    out = []
    for r in info["ranks"]:
        check_launches(r["launches"], want, f"{what} rank {r['rank']}",
                       device)
        rest = [a - b - c for a, b, c in zip(r["sweep_ms"], r["pull_ms"],
                                             r["collective_ms"])]
        out.append({"rank": r["rank"], "device": r["device"],
                    "launches": r["launches"], "step_ms": r["sweep_ms"],
                    "pull_ms": r["pull_ms"],
                    "collective_ms": r["collective_ms"],
                    "reduce_ms": r["reduce_ms"], "gather_ms": r["gather_ms"],
                    "rest_ms": rest,
                    "max_memory_allocated": r["max_memory_allocated"]})
    return out


def spmd_train(torch, seed: int, card: str, corp, device: str = "cuda",
               v: int = V_FULL, k: int = K_FULL, block_tokens: int = 8192,
               sweeps: int = 3, ranks: int = SPMD_RANKS,
               model: int = SPMD_MODEL) -> dict:
    """The SPMD plane at (v, k) on ``corp``: APSLDA(LDAJob(...,
    backend="spmd", mesh_model=model), devices=ranks) with
    HybridRoute(2000), ``sweeps`` sweeps; exact conservation of the whole
    mesh's state (the gathered n_wk and n_k are the histogram of the
    gathered z, the token mass the corpus's), falling perplexity, and each
    rank's own launches, peak device memory and ms per sweep by part."""
    from repro_torch.api import APSLDA, HybridRoute, LDAJob
    from repro_torch.kernels import ops

    job = LDAJob(corpus=corp, num_topics=k, vocab_size=v,
                 route=HybridRoute(hot_words=HOT_WORDS),
                 block_tokens=block_tokens, sweeps=sweeps, eval_every=1,
                 backend="spmd", mesh_model=model, seed=seed)
    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    est = APSLDA(job, log_fn=log, device=device, devices=ranks)
    m = est.fit()
    sync(torch, device)
    parent = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    res = est.result_
    info = res.info
    conservation(torch, res.state, "spmd_train")
    if int(res.nk.value.sum()) != corp.num_tokens:
        raise AssertionError("spmd_train: the token mass changed")
    ppl = [row["perplexity"] for row in m.history]
    if not (len(ppl) == sweeps and ppl[-1] < ppl[0]):
        raise AssertionError(f"spmd_train: perplexity did not fall: {ppl}")
    groups = res.state.w.shape[0] // ranks // block_tokens
    want = spmd_expected(groups * sweeps, sweeps, coo=True)
    per_rank = spmd_ranks(info, want, "spmd_train", device)
    if device == "cuda" and info["collective"] != (
            "nccl" if ranks <= torch.cuda.device_count() else "gloo"):
        raise AssertionError(f"spmd_train: transport {info['collective']}")
    log(json.dumps({"spmd": {
        "run": "train", "V": v, "K": k, "tokens": corp.num_tokens,
        "ranks": ranks, "mesh": [info["mesh_data"], info["mesh_model"]],
        "collective": info["collective"], "route": info["route"],
        "groups_per_sweep_per_rank": groups, "perplexity": ppl,
        "parent_launches": parent, "per_rank": per_rank, "checks": "ok",
        "card": card}}))
    totals = {name: sum(r["launches"][name] for r in per_rank)
              for name in want}
    return {"launches": totals, "ranks": per_rank, "groups": groups}


def spmd_stream(torch, seed: int, card: str, corp, device: str = "cuda",
                v: int = V_FULL, k: int = K_FULL,
                tokens_per_shard: int = STREAM_SHARD_TOKENS,
                block_tokens: int = 8192, epochs: int = 2,
                ranks: int = SPMD_RANKS, model: int = SPMD_MODEL) -> dict:
    """The streamed SPMD plane on ``corp`` in shards of
    ``tokens_per_shard`` (stream_train's; raised by blocks until the shard
    count splits over the ranks), ``ranks`` shards a visit, for
    ``epochs`` epochs with HybridRoute(2000): after each epoch a callback
    reads the view's n_wk and n_k (gathered from the ranks on demand) and
    holds them to the histogram of the z files; the perplexity falls; each
    rank's launches."""
    import tempfile

    from repro_torch.api import APSLDA, Callback
    from repro_torch.data import stream
    from repro_torch.kernels import ops

    class EpochConservation(Callback):
        def __init__(self, reader, every):
            self.reader, self.every, self.checks = reader, every, []

        def on_sweep_end(self, view):
            if view.step % self.every:
                return
            rw, rk = stream.rebuild_counts_from_stream(self.reader, k)
            self.checks.append({
                "epoch": view.epoch,
                "nwk": bool(np.array_equal(view.nwk.to_dense().cpu().numpy(),
                                           rw)),
                "nk": bool(np.array_equal(view.nk.value.cpu().numpy(), rk)),
                "tokens": int(rk.sum()) == corp.num_tokens})

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "s")
        meta = spmd_shards(stream, corp, path, ranks, block_tokens,
                           tokens_per_shard)
        tokens_per_shard = meta.tokens_per_shard
        job = stream_job(path, k, v, seed, epochs, block_tokens=block_tokens,
                         backend="spmd", mesh_model=model,
                         eval_every=meta.num_shards)
        cb = EpochConservation(stream.ShardedCorpusReader(path),
                               meta.num_shards)
        ops.reset_launch_counts()
        # -------------------------------------------------------- main path
        est = APSLDA(job, log_fn=log, device=device, devices=ranks)
        m = est.fit([cb])
        sync(torch, device)
        parent = ops.launch_counts()
        # ------------------------------------------------ end of main path
        info = est.result_.info
        ppl = [row["perplexity"] for row in m.history]
        ok = (len(cb.checks) == epochs
              and all(c["nwk"] and c["nk"] and c["tokens"]
                      for c in cb.checks)
              and len(ppl) == epochs and ppl[-1] < ppl[0])
        visits = epochs * meta.num_shards // ranks
        groups = visits * (tokens_per_shard // block_tokens)
        want = spmd_expected(groups, visits, coo=True)
        per_rank = spmd_ranks(info, want, "spmd_stream", device)
        log(json.dumps({"spmd": {
            "run": "stream", "V": v, "K": k, "shards": meta.num_shards,
            "tokens_per_shard": tokens_per_shard, "epochs": epochs,
            "ranks": ranks, "collective": info["collective"],
            "visits_per_rank": visits, "epoch_checks": cb.checks,
            "perplexity": ppl, "parent_launches": parent,
            "per_rank": per_rank, "card": card}}))
        if not ok:
            raise AssertionError(f"spmd_stream failed: {cb.checks} {ppl}")
    return {"ranks": per_rank}


def spmd_shards(stream, corp, path: str, ranks: int, block_tokens: int,
                tokens_per_shard: int):
    """Write ``corp`` as a stream whose shard count the ranks split: the
    first multiple of ``block_tokens`` from ``tokens_per_shard`` on that
    gives one."""
    tps = tokens_per_shard
    while True:
        meta = stream.write_sharded(path, corp, tps)
        if meta.num_shards % ranks == 0:
            return meta
        shutil.rmtree(path)
        tps += block_tokens


def spmd_nccl(torch, seed: int, card: str, corp, v: int = V_FULL,
              k: int = K_FULL, block_tokens: int = 8192) -> dict:
    """One rank on NCCL at (v, k) for one sweep (the transport of a rank
    with a card of its own): conservation, and its state equal bitwise to
    the same one-rank job with the transport pinned to gloo."""
    from repro_torch.api import APSLDA, HybridRoute, LDAJob
    from repro_torch.api import session as sess
    from repro_torch.kernels import ops

    job = LDAJob(corpus=corp, num_topics=k, vocab_size=v,
                 route=HybridRoute(hot_words=HOT_WORDS),
                 block_tokens=block_tokens, sweeps=1, eval_every=0,
                 backend="spmd", mesh_model=1, seed=seed)
    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    est = APSLDA(job, log_fn=log, device="cuda", devices=1)
    est.fit()
    sync(torch, "cuda")
    parent = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    res = est.result_
    if res.info["collective"] != "nccl":
        raise AssertionError(f"one rank with a card: transport "
                             f"{res.info['collective']}, expected nccl")
    conservation(torch, res.state, "spmd_nccl")
    groups = res.state.w.shape[0] // block_tokens
    per_rank = spmd_ranks(res.info, spmd_expected(groups, 1, coo=True),
                          "spmd_nccl", "cuda")
    plane = sess._SpmdPlane(corp, job.lda_config(v), job.exec_config(), 1,
                            seed=seed, mesh_model=1, devices=1,
                            log_fn=lambda m: None, device="cuda",
                            transport="gloo")
    gloo = sess._run_loop(plane, [])
    equal = {name: bool(torch.equal(a, b)) for name, a, b in (
        ("nwk", res.nwk.value, gloo.nwk.value),
        ("nk", res.nk.value, gloo.nk.value),
        ("z", res.state.z, gloo.state.z),
        ("ndk", res.state.ndk, gloo.state.ndk))}
    log(json.dumps({"spmd": {
        "run": "nccl_w1", "V": v, "K": k, "collective": "nccl",
        "compared_with": gloo.info["collective"], "equal": equal,
        "parent_launches": parent, "per_rank": per_rank, "card": card}}))
    if not all(equal.values()):
        raise AssertionError(f"W = 1 on NCCL differs from gloo: {equal}")
    return {"ranks": per_rank, "gloo_ranks": gloo.info["ranks"]}


SPMD_ROUTES = {"dense": None, "hybrid": 200, "coo": 0}


def spmd_small_run(torch, seed: int, plane: str, route: str, device: str,
                   tmp: str, v: int = 3000, k: int = 64,
                   ranks: int = SPMD_RANKS, model: int = SPMD_MODEL) -> dict:
    """One small SPMD job on ``device`` (staleness 1, 1,024-token blocks):
    the memory plane for 2 sweeps or the stream plane for 2 epochs; its
    n_wk, n_k and z and n_dk (memory) or every z file (stream), as numpy."""
    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data import stream
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(300, v, true_topics=16, seed=seed)
    if plane == "memory":
        job = LDAJob(corpus=corp, sweeps=2)
    else:
        path = str(Path(tmp) / f"{route}_{device}")
        spmd_shards(stream, corp, path, ranks, 1024, 4096)
        job = LDAJob(stream_dir=path, epochs=2)
    job = dataclasses.replace(job, num_topics=k, vocab_size=v,
                              hot_words=SPMD_ROUTES[route], block_tokens=1024,
                              eval_every=0, backend="spmd", mesh_model=model,
                              staleness=1, seed=seed)
    est = APSLDA(job, log_fn=lambda m: None, device=device, devices=ranks)
    est.fit()
    r = est.result_
    out = {"nwk": r.nwk.value.cpu().numpy(), "nk": r.nk.value.cpu().numpy(),
           "collective": np.asarray(r.info["collective"])}
    if plane == "memory":
        out.update(z=r.state.z.cpu().numpy(), ndk=r.state.ndk.cpu().numpy())
    else:
        out["z_files"] = np.stack([r.reader.read_z(s)
                                   for s in range(r.reader.num_shards)])
    return out


def spmd_cpu_runs(torch, seed: int, out_dir: str) -> None:
    """Every small SPMD job of spmd_card_vs_cpu on the CPU, each saved to
    ``out_dir/<plane>_<route>.npz`` (``chip_smoke.py --spmd-cpu DIR``:
    a process of its own, so that it runs beside the card's jobs)."""
    for plane in ("memory", "stream"):
        for route in SPMD_ROUTES:
            np.savez(Path(out_dir) / f"{plane}_{route}.npz",
                     **spmd_small_run(torch, seed, plane, route, "cpu",
                                      out_dir))


def spmd_card_vs_cpu(torch, seed: int, card: str, v: int = 3000,
                     k: int = 64) -> None:
    """W = 4 ranks on the card (sharing it) against W = 4 on the CPU, for
    the memory and the stream plane and the dense, hybrid and COO routes:
    n_wk, n_k, and z and n_dk (memory) or every z file (stream) equal
    bitwise.  The CPU's jobs run in a process of their own, beside the
    card's."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        log_path = Path(tmp) / "cpu.log"
        with open(log_path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
                 str(seed), "--spmd-cpu", tmp], cwd=str(ROOT),
                stdin=subprocess.DEVNULL, stdout=out,
                stderr=subprocess.STDOUT)
        try:
            runs = {(plane, route): spmd_small_run(torch, seed, plane, route,
                                                   "cuda", tmp, v, k)
                    for plane in ("memory", "stream")
                    for route in SPMD_ROUTES}
            if proc.wait(timeout=600) != 0:
                raise AssertionError(f"the CPU's SPMD jobs failed:\n"
                                     f"{log_path.read_text()[-4000:]}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        for (plane, route), got in runs.items():
            with np.load(Path(tmp) / f"{plane}_{route}.npz") as ref:
                equal = {n: bool(np.array_equal(got[n], ref[n]))
                         for n in got if n != "collective"}
            log(json.dumps({"check": "spmd_card_vs_cpu", "plane": plane,
                            "route": route, "V": v, "K": k,
                            "ranks": SPMD_RANKS,
                            "collective": str(got["collective"]),
                            "equal": equal}))
            if not all(equal.values()):
                raise AssertionError(f"SPMD {plane} plane, {route} route: "
                                     f"the card differs from the CPU: "
                                     f"{equal}")


# -- phases 15-16: the Spark-LDA baselines (Table 1), the traced replay ------

TABLE1_KS = (80, K_FULL)        # the paper's largest Spark K, and APS-LDA's
EM_ITERS, ONLINE_BATCHES, ONLINE_BATCH_DOCS = 10, 30, 128
EM_PEAK_BYTES = 16e9            # EM's own device memory at K = 1,000
# card = CPU tolerances of the baselines (float32 in another order): the
# port-vs-JAX maxima measured on the CPU (EM 1.2e-6 after 1 iteration,
# 6.7e-5 after 20; online VB 2.1e-5 after 1 step, 1.5e-4 after 30), with
# a margin of 1.5-8x; tests/test_torch_baselines.py holds the port to the
# JAX package with the same figures
BASELINE_CASES = (("em", 1, 1e-5), ("em", 20, 1e-4),
                  ("online", 1, 1e-4), ("online", 30, 1e-3))
QUALITY_GAP = 0.15              # EM vs LightLDA (tests/test_lda_baselines)
# -- the LM serving path (gemma3-4b at full width) ---------------------------

BF16_FLOPS = 989e12            # H100 SXM bf16 dense, tensor cores
LM_ARCH = "gemma3-4b"
# the greedy tokens cut from 128 to 64 when the examples joined the
# script (its time; PERF.md section 4)
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK_STEPS = 4, 2048, 64, 8
# cache against full forward, bf16: a decode step and the full forward
# round the same values through other kernels (a [B, 1] against a
# [B, S] product, other accumulation orders), so each of the 34 layers'
# two residual branches can differ by about one bf16 rounding (2^-8
# relative) of its output.  Eight such ulps of the row's largest logit
# bound the drift of a step's logits; a cache fault (a wrong slot, window
# or RoPE position) moves them by the logits' own scale.
LM_BF16_TOL = 8 * 2.0 ** -8
# card against CPU at the smoke sizes (float32, TF32 off), as the CPU
# parity tests hold the port to the JAX package
LM_RTOL, LM_ATOL = 1e-4, 1e-5
LM_SMOKE_STEPS = 8


def lm_decode_bytes(model, batch: int, pos: int) -> int:
    """Bytes a decode step at ``pos`` must read: every weight once (the
    tied head reads the whole table) and each attention layer's K and V
    over the slots its query sees (its window, or the filled prefix)."""
    from repro_torch.models.attention import live_range
    cfg = model.cfg
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    slot = cfg.num_kv_heads * cfg.head_dim_ * 2 * model.embed.table.element_size()
    for w in cfg.windows():
        lo, hi = live_range(pos, w)
        n += batch * (hi - lo) * slot
    return n


def lm_prefill_flops(model, batch: int, prompt: int) -> int:
    """FLOPs prefill must do: every block's matmul weights once a token
    (2 a weight), attention over the (query, key) pairs the causal mask
    and the window leave (QK^T and PV, 2 each a pair and head dim), and
    the head on the last position only."""
    cfg = model.cfg
    blocks = list(model.blocks) + list(getattr(model, "dense_blocks", []))
    weights = sum(p.numel() for b in blocks for p in b.parameters()
                  if p.dim() >= 2)
    flops = 2 * batch * prompt * weights
    for w in cfg.windows():
        pairs = sum(min(q + 1, w) if w else q + 1 for q in range(prompt))
        flops += 4 * batch * cfg.num_heads * cfg.head_dim_ * pairs
    return flops + 2 * batch * cfg.d_model * model.layout.pad_rows


def lm_card_vs_cpu(torch, seed: int, device: str, batch: int = 2,
                   prompt: int = 24, names=None) -> dict:
    """Each arch's smoke variant (float32) with the same weights on the
    card and on the CPU: prefill and LM_SMOKE_STEPS decode steps fed the
    CPU's greedy tokens; logits within LM_RTOL / LM_ATOL, greedy tokens
    equal except at a near tie (top-2 margin of the CPU's logits under the
    tolerance), which is counted."""
    from repro_torch import rng as jrng
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    out = {}
    for name in names or registry.all_arch_names():
        cfg = registry.smoke_variant(name)
        ref = tfm.init_params(seed, cfg, device="cpu")
        card = tfm.Transformer(cfg, device=device)
        card.load_state_dict(ref.state_dict())
        prompts = jrng.randint(jrng.PRNGKey(seed), (batch, prompt), 0,
                               cfg.vocab_size)
        cond = None
        if cfg.cross_attn_mode:
            cond = torch.randn((batch, cfg.cond_len, cfg.cond_dim_),
                               generator=torch.Generator().manual_seed(seed))
        runs, toks = [], []          # the CPU's greedy tokens, fed to both
        for model, dev in ((ref, "cpu"), (card, device)):
            c = None if cond is None else cond.to(dev)
            with torch.no_grad():
                caches = tfm.allocate_cache(cfg, batch,
                                            prompt + LM_SMOKE_STEPS, dev)
                logits, _ = tfm.prefill(model, prompts.to(dev), c, caches)
                rows = [logits.cpu()]
                for i in range(LM_SMOKE_STEPS):
                    if len(toks) == i:
                        toks.append(rows[-1].argmax(-1))
                    logits, _ = tfm.decode_step(model, toks[i].to(dev),
                                                caches, prompt + i, c)
                    rows.append(logits.cpu())
            runs.append(torch.stack(rows))
        want, got = runs
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=LM_RTOL, atol=LM_ATOL):
            raise AssertionError(f"{name}: card logits differ from the CPU's "
                                 f"by {err:.3g} (rtol {LM_RTOL}, atol "
                                 f"{LM_ATOL})")
        top2 = want.topk(2, dim=-1).values
        tie = (top2[..., 0] - top2[..., 1]) < 2 * (
            LM_ATOL + LM_RTOL * top2[..., 0].abs())
        differ = got.argmax(-1) != want.argmax(-1)
        if bool((differ & ~tie).any()):
            raise AssertionError(f"{name}: the card's greedy token differs "
                                 f"from the CPU's away from a near tie")
        out[name] = {"max_abs_err": err, "near_ties": int(tie.sum()),
                     "tokens_differ_at_ties": int(differ.sum())}
    return out


def lm_serve(torch, seed: int, card: str, device: str = "cuda",
             batch: int = LM_BATCH, prompt: int = LM_PROMPT,
             gen: int = LM_GEN, layers: int = 0) -> dict:
    """gemma3-4b at full width through ``repro_torch.launch.serve``'s main
    on the card (``layers`` cuts the depth for a CPU rehearsal): shapes and
    token range, a second generation equal to the first, a timed prefill
    and decode loop equal to ``generate``, the first LM_CHECK_STEPS decode
    steps' logits against one full-sequence forward, one decode step under
    the profiler, the bounds; then every arch's smoke variant on the card
    against the CPU."""
    from repro_torch.launch import serve as serve_launch

    argv = ["--arch", LM_ARCH, "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen", str(gen), "--seed", str(seed),
            "--device", device]
    if layers:
        argv += ["--layers", str(layers)]
    if device == "cuda":
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    res = serve_launch.main(argv)
    eng, prompts, out = res.engine, res.prompts, res.out
    cfg = eng.cfg
    if (cfg.d_model, cfg.vocab_size, cfg.dtype) != (2560, 262_144,
                                                    "bfloat16") or \
            cfg.num_layers != (layers or 34):
        raise AssertionError(f"not gemma3-4b's full config: {cfg}")
    if tuple(out.shape) != (batch, gen) or out.dtype != torch.int32:
        raise AssertionError(f"output {tuple(out.shape)} {out.dtype}")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("a generated token is out of the vocabulary")
    gen_ms = [res.seconds * 1e3]

    sync(torch, device)
    t0 = time.perf_counter()
    again = eng.generate(prompts, gen)
    sync(torch, device)
    gen_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.equal(again, out):
        raise AssertionError("a second generate on the same prompts differs")

    # the engine's loop, each part timed: prefill, then one step a token
    sync(torch, device)
    t0 = time.perf_counter()
    logits, caches = eng.prefill(prompts)
    tok = eng.sample(logits, None)
    sync(torch, device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    toks, step_ms, step_logits = [tok], [], []
    for i in range(gen - 1):
        t = time.perf_counter()
        logits = eng.step(tok, caches, prompt + i)
        tok = eng.sample(logits, None)
        sync(torch, device)
        step_ms.append((time.perf_counter() - t) * 1e3)
        if i < LM_CHECK_STEPS:
            step_logits.append(logits)
        toks.append(tok)
    gen_ms.append(prefill_ms + sum(step_ms))
    if not torch.equal(torch.stack(toks, dim=1), out):
        raise AssertionError("the timed prefill + decode loop differs from "
                             "generate")

    # cache against full forward: the decode step at prompt + i consumed
    # out[:, i]; the forward over prompt + out[:, :8] gives the logits at
    # the same positions
    seq = torch.cat([prompts, out[:, :LM_CHECK_STEPS]], dim=1)
    with torch.no_grad():
        full, _ = eng.model(seq, head_at=slice(prompt,
                                               prompt + LM_CHECK_STEPS))
    dec = torch.stack(step_logits, dim=1).float()
    full = full.float()
    scale = full.abs().amax(-1, keepdim=True)
    rel = float(((dec - full).abs() / scale).max())
    argmax_agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    if not rel <= LM_BF16_TOL:
        raise AssertionError(f"decode logits differ from the full forward "
                             f"by {rel:.4g} of the row's largest logit "
                             f"(tolerance {LM_BF16_TOL:.4g})")
    del full, dec, step_logits

    stats = {}
    if device == "cuda":
        peak = torch.cuda.max_memory_allocated()
        pos = prompt + gen - 1
        wall, busy, stats = device_profile(
            torch, lambda: eng.sample(eng.step(tok, caches, pos), None))
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "lm_decode_profile.txt").write_text(
            f"{card}\none decode step of {LM_ARCH} at batch {batch}, "
            f"position {pos}: wall {wall:.3f} ms (profiler on), device busy "
            f"{busy:.3f} ms\n\n{profile_table(stats)}\n")
    model = eng.model
    mean_bytes = float(np.mean([lm_decode_bytes(model, batch, prompt + i)
                                for i in range(gen - 1)]))
    decode_ms = float(np.median(step_ms))
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "batch": batch,
        "prompt": prompt, "gen": gen, "device": device,
        "params": sum(p.numel() for p in model.parameters()),
        "prefill_ms": prefill_ms,
        "decode_step_ms_median": decode_ms,
        "decode_step_ms_min": min(step_ms), "decode_step_ms_max": max(step_ms),
        "generate_ms_runs": gen_ms,
        "generate_ms_median": float(np.median(gen_ms)),
        "tokens_per_s": batch * gen / (float(np.median(gen_ms)) / 1e3),
        "decode_bound_ms": mean_bytes / HBM_BYTES_PER_S * 1e3,
        "decode_bound_bytes": mean_bytes,
        "prefill_bound_ms": lm_prefill_flops(model, batch, prompt)
        / BF16_FLOPS * 1e3,
        "prefill_flops": lm_prefill_flops(model, batch, prompt),
        "cache_vs_forward_rel_err": rel, "cache_vs_forward_tol": LM_BF16_TOL,
        "cache_vs_forward_argmax_agree": argmax_agree,
        "card": card}
    if device == "cuda":
        summary.update({
            "peak_mem_gb": peak / 1e9,
            "phase_peak_mem_gb": (peak - base_mem) / 1e9,
            "decode_profiled_wall_ms": wall, "decode_device_busy_ms": busy,
            "decode_device_idle_share": 1.0 - busy / wall,
            "decode_kernels": sum(n for n, _ in stats.values())})
    else:
        summary.update(dict.fromkeys(
            ("peak_mem_gb", "decode_device_idle_share", "decode_kernels"),
            "not measured"))
    log(f"[lm_serve] {cfg.name}: prefill {prefill_ms:.1f} ms, decode step "
        f"{decode_ms:.2f} ms (bound {summary['decode_bound_ms']:.3f}), "
        f"{summary['tokens_per_s']:.1f} tok/s; cache vs forward {rel:.4g} "
        f"of the largest logit")
    del eng, caches, model, res
    if device == "cuda":
        torch.cuda.empty_cache()
    summary["card_vs_cpu"] = lm_card_vs_cpu(torch, seed, device)
    log(json.dumps({"lm_serve": summary}))
    return summary



# -- one LM mesh kept open across phases -------------------------------------

class MeshPool:
    """An LM mesh (``LMTrainRun``, whose ranks also serve) kept open from
    one phase to the next of the same shape, so that the script starts it
    once: ``use(shape)`` hands out the open mesh of that shape, or closes
    the open one and starts another.  A launcher cell starts a mesh of its
    own with this process as its rank 0, and a process joins one process
    group at a time: ``close()`` first.  With ``keep=False`` (a phase run
    alone) each ``use`` closes its mesh at the end."""

    def __init__(self, torch, device: str, keep: bool = True):
        self.torch, self.device, self.keep = torch, device, keep
        self.run, self.shape = None, None
        self.starts, self.reuses = [], 0

    @contextlib.contextmanager
    def use(self, shape):
        if self.run is not None and self.shape == tuple(shape):
            self.reuses += 1
        else:
            self.close()
            from repro_torch.train.mesh_worker import LMTrainRun
            if self.device == "cuda":
                self.torch.cuda.empty_cache()
            t = time.perf_counter()
            run = LMTrainRun({"data": shape[0], "model": shape[1]},
                             self.torch.device(self.device))
            run.start()
            self.run, self.shape = run, tuple(shape)
            self.starts.append({"shape": list(shape),
                                "s": time.perf_counter() - t})
        try:
            yield self.run
        except BaseException:
            self.close()
            raise
        if not self.keep:
            self.close()

    def close(self) -> None:
        run, self.run, self.shape = self.run, None, None
        if run is not None:
            try:
                run.finish()
            finally:
                run.close()


# -- LM serving on a device mesh (deepseek-v2-lite-16b 1 x 4, gemma3-4b 2 x 2)

LM_MESH_ARCH = "deepseek-v2-lite-16b"
LM_MESH_SHAPE = (1, 4)            # data x model: 4 gloo ranks share the card
# the timed greedy tokens cut from 64 to 16 when the SSM and long-context
# mesh phases joined the script, and to 8 when the examples did (its
# 1,200 s limit; PERF.md section 4): the config, check (a) and the prefill
# stay whole, the decode median is over 7 steps
LM_MESH_BATCH, LM_MESH_PROMPT, LM_MESH_GEN = 4, 2048, 8
LM_MESH_CF = 1.25                 # the config's capacity factor
LM_MESH_CHECK_PROMPT = 64         # check (a): prompt, then LM_CHECK_STEPS
# check (a): mesh logits against the single-device run of the same seed on
# the card, within 1/32 of each row's largest logit (PR 20's bound), held
# with the config's weights widened to float32.  In bf16 the two differ by
# a few ulps a layer (another order of the row-parallel sums, other GEMM
# shapes), which flips near-tied top-6 routing choices, and 26 MoE layers
# compound the flips: on the CPU a 27-layer deepseek of d_model 512 gave
# 0.30 of the row's largest logit in bf16 and 2.4e-6 in float32.  The
# bf16 difference is measured and reported.
LM_MESH_TOL = 1.0 / 32
# check (b): the first MoE layer on every rank against its emulation on
# the same input: the routed rows are the same operations on the same
# blocks (bitwise where the GEMMs are; a CPU's thread count can move an
# expert's bf16 output by an ulp, and the combine rounds once more: two
# bf16 roundings); the whole output adds the shared experts, row-parallel
# on the mesh and whole in the emulation
LM_MOE_ROUTED_TOL, LM_MOE_TOL = 2.0 ** -7, 2.0 ** -5
LM_DP_ARCH, LM_DP_LAYERS, LM_DP_SHAPE = "gemma3-4b", 6, (2, 2)
LM_DP_BATCH, LM_DP_PROMPT, LM_DP_GEN = 4, 2048, 32
LM_MESH_SMOKE_STEPS = 4


def mesh_logical(torch, logits, cfg, shape):
    """A mesh's physical logits rows in logical vocab order."""
    from repro_torch.launch.mesh import MeshLayout, ctx_for
    from repro_torch.models import transformer as tfm
    lay = tfm.vocab_layout(cfg, ctx_for(MeshLayout(*shape)))
    return logits[..., torch.as_tensor(lay.to_physical(
        torch.arange(cfg.vocab_size)))]


def single_logits(torch, cfg, seed: int, tokens, steps: int, device: str,
                  cond=None, all_positions: bool = False):
    """The single-device model of ``seed`` on ``device``: the logits the
    mesh's ``op_logits`` returns (the prompt ``tokens[:, :-steps]``, then
    ``steps`` teacher-forced decode steps), float32 on the CPU."""
    from repro_torch.models import transformer as tfm
    model = tfm.init_params(seed, cfg, device=device)
    tok = tokens.to(device)
    c = None if cond is None else cond.to(device)
    sp = tok.shape[1] - steps
    caches = tfm.allocate_cache(cfg, tok.shape[0], tok.shape[1], device)
    with torch.no_grad():
        full, _ = model(tok[:, :sp], c, caches=caches,
                        head_at=None if all_positions else slice(-1, None),
                        remat=False)
        outs = [full.float()]
        for i in range(steps):
            outs.append(model.decode_step(tok[:, sp + i], caches, sp + i,
                                          c).float()[:, None])
    out = torch.cat(outs, dim=1).cpu()
    del model, caches, full, outs
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def row_rel(got, want) -> float:
    """The largest difference as a share of its row's largest |logit|."""
    scale = want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return float(((got - want).abs() / scale).max())


def coll_summary(coll: dict, per: int = 1) -> dict:
    """A part's collectives by kind: ms and bytes (per step when ``per``
    steps ran), calls; all-to-all (with its host staging), all-reduce,
    all-gather."""
    kinds = {"all_to_all": ("moe_push", "moe_pull", "moe_push.staging",
                            "moe_pull.staging"),
             "all_reduce": ("embed", "attn", "mlp", "moe_aux", "ssm",
                            "norm"),
             "all_gather": ("logits", "moe_gather", "weights", "kv", "seq",
                            "experts", "tokens", "ssm_weights", "lse")}
    out = {}
    for kind, tags in kinds.items():
        out[kind] = {k: sum(coll.get(t, {}).get(k, 0) for t in tags) / per
                     for k in ("ms", "bytes", "calls")}
    out["ms"] = sum(v.get("ms", 0.0) for v in coll.values()) / per
    out["by_tag"] = {t: {k: v[k] / per for k in v} for t, v in coll.items()}
    return out


def param_bytes(cfg) -> int:
    """The single-device model's parameter bytes (the meta device)."""
    from repro_torch.models import transformer as tfm
    model = tfm.Transformer(cfg, device="meta")
    return sum(p.numel() * p.element_size() for p in model.parameters())


def ssd_flops(cfg, tokens: int) -> int:
    """FLOPs the SSM mixers' scans must do over ``tokens`` positions: the
    recurrence's state update and read, 4 H P N a token and SSM layer (the
    chunked form's extra intra-chunk products are work the bound need not
    do); 0 without an SSM."""
    if not cfg.ssm_state:
        return 0
    return 4 * tokens * cfg.num_layers * cfg.ssm_heads * cfg.ssm_head_dim \
        * cfg.ssm_state


def mesh_flops(cfg, batch: int, prompt: int, shape, cf: float) -> dict:
    """Prefill FLOPs: what the function must do (every non-expert matmul
    weight once a token, top-k experts a token, attention over the causal
    pairs, the head on the last position), the expert-parallel path's
    expert FLOPs at capacity factor ``cf`` (each rank's local experts on
    their cap2 buffers) and the dense path's (every expert on every
    token)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    model = tfm.Transformer(cfg, device="meta")
    fe = cfg.moe_d_ff or cfg.d_ff
    expert = 6 * cfg.d_model * fe          # gate, up, down: 2 a weight
    moe_layers = sum(1 for _, _, b, _, _ in model.schedule()
                     if hasattr(b, "moe"))
    dense_w = sum(p.numel() for n, p in model.named_parameters()
                  if p.dim() >= 2 and ".experts." not in n and "table" not in n)
    toks = batch * prompt
    if cfg.use_mla:
        qk, v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        qk = v = cfg.head_dim_
    attn = sum(2 * batch * cfg.num_heads * (qk + v) * sum(
        min(q + 1, w) if w else q + 1 for q in range(prompt))
        for w in cfg.windows())
    need = (2 * toks * dense_w + toks * cfg.top_k * expert * moe_layers
            + attn + 2 * batch * cfg.d_model * cfg.vocab_size
            + ssd_flops(cfg, toks))
    data, m = shape
    t = toks // (data * m)
    cap1 = moe_mod._cap1(t, cfg, m, cf) if cfg.num_experts else 0
    cap2 = moe_mod._cap2(cap1, cfg, m, cf) if cfg.num_experts else 0
    ep = moe_layers * data * m * (cfg.num_experts // m) * cap2 * expert
    return {"need": need, "ep_expert": ep,
            "dense_expert": moe_layers * toks * cfg.num_experts * expert,
            "cap1": cap1, "cap2": cap2}


def mesh_cell_summary(cell: dict, stats: list, batch: int, gen: int,
                      card: str) -> dict:
    """Prefill ms, decode step ms and tokens/s, per-rank peak memory and the
    collectives of one timed run (rank 0's clock and collectives)."""
    steps = cell["step_ms"]
    decode = float(np.median(steps))
    pre = coll_summary(cell["prefill_collectives"])
    dec = coll_summary(cell["decode_collectives"], max(len(steps), 1))
    return {
        "prefill_ms": cell["prefill_ms"],
        "decode_step_ms_median": decode,
        "decode_step_ms_min": min(steps), "decode_step_ms_max": max(steps),
        "tokens_per_s": batch * gen / ((cell["prefill_ms"] + sum(steps))
                                       / 1e3),
        "decode_tokens_per_s": batch / (decode / 1e3),
        "prefill_collectives": pre, "decode_collectives_per_step": dec,
        "prefill_collective_share": pre["ms"] / cell["prefill_ms"],
        "decode_collective_share": dec["ms"] / decode,
        "rank_peak_mem_gb": [None if r["max_memory_allocated"] is None
                             else r["max_memory_allocated"] / 1e9
                             for r in stats],
        "rank_param_gb": [r["param_bytes"] / 1e9 for r in stats],
        "card": card}


def lm_mesh_serve(torch, seed: int, card: str, device: str = "cuda",
                  layers: int = 0, batch: int = LM_MESH_BATCH,
                  prompt: int = LM_MESH_PROMPT, gen: int = LM_MESH_GEN,
                  check_prompt: int = LM_MESH_CHECK_PROMPT,
                  check_steps: int = LM_CHECK_STEPS) -> dict:
    """deepseek-v2-lite-16b at its full config on a data 1 x model 4 mesh
    of gloo ranks sharing the card (``layers`` cuts the depth for a CPU
    rehearsal): (a) at a capacity factor where neither level of the
    expert-parallel path can drop (max(M, E/M)), the prefill's and 8
    teacher-forced decode steps' logits against the single-device run of
    the same seed, run after the mesh has gone: held in float32, measured
    in bf16 (LM_MESH_TOL); then the cell in bf16 at the config's capacity
    factor: batch 4, prompt 2,048, ``gen`` greedy tokens, timed, with each MoE
    layer's dropped share, the collectives and the bounds; (b) the first
    MoE layer at the cell's shape on every rank against
    ``moe_block_spmd_emulated``."""
    from repro_torch import rng as jrng
    from repro_torch.configs import registry
    from repro_torch.serve.mesh_worker import LMMeshRun

    cfg = registry.get(LM_MESH_ARCH)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    elif (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.use_mla,
          cfg.num_experts, cfg.top_k, cfg.num_shared_experts,
          cfg.vocab_size, cfg.dtype) != (27, 2048, 16, True, 64, 6, 2,
                                         102_400, "bfloat16"):
        raise AssertionError(f"not deepseek-v2-lite-16b's full config: {cfg}")
    data, m = LM_MESH_SHAPE
    nodrop = float(max(m, cfg.num_experts // m))
    v = cfg.vocab_size
    tokens_a = jrng.randint(jrng.PRNGKey(seed), (batch, check_prompt
                                                  + check_steps), 0, v)
    prompts = jrng.randint(jrng.PRNGKey(seed + 1), (batch, prompt), 0, v)
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with LMMeshRun({"data": data, "model": m}, torch.device(device)) as run:
        spawn_s = time.perf_counter() - t0
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        load32 = run.call("load", cfg32, seed=seed, capacity_factor=nodrop)
        a = run.call("logits", tokens_a, check_steps, None, False)
        load = run.call("load", cfg, seed=seed, capacity_factor=nodrop,
                        max_seq=prompt + gen + 1)
        a16 = run.call("logits", tokens_a, check_steps, None, False)
        run.call("set", capacity_factor=LM_MESH_CF)
        run.call("reset_peak")
        cell = run.call("generate", prompts, gen, timed=True)
        b = run.call("moe_check", (batch, prompt, cfg.d_model), seed)
        stats = run.call("stats")
        transport = run.transport
    mesh_s = time.perf_counter() - t0
    if any(d for d, _ in a["drops"] + a16["drops"]):
        raise AssertionError(f"pairs dropped at capacity factor {nodrop}: "
                             f"{a['drops']} {a16['drops']}")
    t1 = time.perf_counter()
    checks = {}
    for name, c, res_a in (("float32", cfg32, a), ("bfloat16", cfg, a16)):
        got = mesh_logical(torch, res_a["logits"], c, LM_MESH_SHAPE)
        want = single_logits(torch, c, seed, tokens_a, check_steps, device)
        checks[name] = {
            "max_rel_err": row_rel(got, want),
            "max_rel_err_by_position": [row_rel(got[:, i], want[:, i])
                                        for i in range(got.shape[1])],
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}
        del got, want
    single_s = time.perf_counter() - t1
    rel = checks["float32"]["max_rel_err"]
    if not rel <= LM_MESH_TOL:
        raise AssertionError(f"mesh logits differ from the single device by "
                             f"{rel:.4g} of the row's largest (tolerance "
                             f"{LM_MESH_TOL})")
    if not (b["routed_max_rel_err"] <= LM_MOE_ROUTED_TOL
            and b["max_rel_err"] <= LM_MOE_TOL
            and (b["dropped"], b["pairs"]) == (b["dropped_emulated"],
                                               b["pairs_emulated"])):
        raise AssertionError(f"the first MoE layer differs from its "
                             f"emulation: {b}")
    out = cell["tokens"]
    if tuple(out.shape) != (batch, gen) or int(out.min()) < 0 or \
            int(out.max()) >= v:
        raise AssertionError(f"mesh tokens {tuple(out.shape)} out of range")
    drops = [{"layer": i, "dropped": d, "pairs": n, "share": d / n}
             for i, (d, n) in enumerate(cell["prefill_drops"])]
    nbytes = param_bytes(cfg)
    cache = (cfg.num_layers * batch * (cfg.kv_lora_rank + cfg.qk_rope_dim)
             * 2 * (prompt + gen / 2))
    fl = mesh_flops(cfg, batch, prompt, LM_MESH_SHAPE, LM_MESH_CF)
    summary = {
        "arch": cfg.name, "layers": cfg.num_layers, "mesh": list(
            LM_MESH_SHAPE), "transport": transport, "device": device,
        "batch": batch, "prompt": prompt, "gen": gen,
        "capacity_factor": LM_MESH_CF, "params": cfg.param_count(),
        "param_bytes": nbytes, "spawn_s": spawn_s, "load_s": load["load_s"],
        "load_float32_s": load32["load_s"],
        "mesh_phase_s": mesh_s, "single_device_s": single_s,
        **mesh_cell_summary(cell, stats, batch, gen, card),
        "prefill_dropped_share": sum(x["dropped"] for x in drops)
        / max(sum(x["pairs"] for x in drops), 1),
        "prefill_drops_by_layer": drops,
        "decode_bound_bytes": nbytes + cache,
        "decode_bound_ms": (nbytes + cache) / HBM_BYTES_PER_S * 1e3,
        "prefill_flops_needed": fl["need"],
        "prefill_bound_ms": fl["need"] / BF16_FLOPS * 1e3,
        "prefill_expert_flops_ep": fl["ep_expert"],
        "prefill_expert_flops_dense": fl["dense_expert"],
        "cap1": fl["cap1"], "cap2": fl["cap2"],
        "check_a": {"capacity_factor": nodrop, "prompt": check_prompt,
                    "steps": check_steps, "held": "float32",
                    "tolerance": LM_MESH_TOL, "drops": a16["drops"],
                    **checks},
        "check_b": dict(b, routed_tolerance=LM_MOE_ROUTED_TOL,
                        tolerance=LM_MOE_TOL)}
    log(f"[lm_mesh] {card}: {cfg.name} {data} x {m} ({transport}): prefill "
        f"{cell['prefill_ms']:.1f} ms (bound {summary['prefill_bound_ms']:.2f}"
        f" ms, {fl['need'] / 1e12:.1f} TFLOP needed; expert FLOPs "
        f"{fl['ep_expert'] / 1e12:.1f} TFLOP expert-parallel vs "
        f"{fl['dense_expert'] / 1e12:.1f} dense)")
    log(f"[lm_mesh] {card}: decode step {summary['decode_step_ms_median']:.2f}"
        f" ms median (bound {summary['decode_bound_ms']:.2f} ms: "
        f"{summary['decode_bound_bytes'] / 1e9:.2f} GB a step), "
        f"{summary['tokens_per_s']:.1f} tokens/s")
    for part, key in (("prefill", "prefill_collectives"),
                      ("decode step", "decode_collectives_per_step")):
        c = summary[key]
        log(f"[lm_mesh] {card}: {part} collectives {c['ms']:.1f} ms "
            f"(all-to-all {c['all_to_all']['ms']:.1f} ms "
            f"{c['all_to_all']['bytes'] / 1e6:.1f} MB, all-reduce "
            f"{c['all_reduce']['ms']:.1f} ms "
            f"{c['all_reduce']['bytes'] / 1e6:.1f} MB, all-gather "
            f"{c['all_gather']['ms']:.1f} ms "
            f"{c['all_gather']['bytes'] / 1e6:.1f} MB on rank 0)")
    log(f"[lm_mesh] {card}: collectives' share: prefill "
        f"{summary['prefill_collective_share']:.3f}, decode "
        f"{summary['decode_collective_share']:.3f}; rank peak memory "
        f"{summary['rank_peak_mem_gb']} GB; dropped share "
        f"{summary['prefill_dropped_share']:.4f}")
    log(f"[lm_mesh] {card}: check (a) float32 {rel:.4g} of the row's "
        f"largest logit (tol {LM_MESH_TOL:.4g}), bf16 "
        f"{checks['bfloat16']['max_rel_err']:.4g} (argmax agree "
        f"{checks['bfloat16']['argmax_agree']:.3f}); check (b) routed "
        f"{b['routed_max_rel_err']:.3g} (bitwise {b['routed_equal']}), "
        f"whole {b['max_rel_err']:.3g}")
    log(json.dumps({"lm_mesh_serve": summary}))
    return summary


def lm_mesh_dp(torch, seed: int, card: str, device: str = "cuda",
               layers: int = LM_DP_LAYERS, batch: int = LM_DP_BATCH,
               prompt: int = LM_DP_PROMPT, gen: int = LM_DP_GEN,
               check_prompt: int = LM_MESH_CHECK_PROMPT,
               check_steps: int = LM_CHECK_STEPS, smoke: bool = True,
               pool: Optional[MeshPool] = None) -> dict:
    """gemma3-4b at full width, depth cut to one 5 local : 1 global period,
    on a data 2 x model 2 mesh (the data axis, the sequence-parallel
    prefill: kv 4 on a model axis of 2, the 262,144-row vocab split):
    through ``repro_torch.launch.serve``'s main with ``--mesh host
    --devices 4 --mesh-model 2`` (its timed parts and every rank's stats);
    then on a second mesh the prefill and 8 teacher-forced decode steps
    against the single-device run; then the eight attention
    architectures' smoke variants (float32) on the same mesh against the
    single-device run on the card.  The second mesh is ``pool``'s (kept
    open for the next phase of its shape)."""
    from repro_torch import rng as jrng
    from repro_torch.configs import registry
    from repro_torch.launch import serve as serve_launch

    pool = pool or MeshPool(torch, device, keep=False)
    pool.close()                 # the launcher's rank 0 is this process
    cfg = dataclasses.replace(registry.get(LM_DP_ARCH), num_layers=layers)
    data, m = LM_DP_SHAPE
    argv = ["--arch", LM_DP_ARCH, "--layers", str(layers), "--batch",
            str(batch), "--prompt-len", str(prompt), "--gen", str(gen),
            "--seed", str(seed), "--device", device, "--mesh", "host",
            "--devices", str(data * m), "--mesh-model", str(m)]
    t0 = time.perf_counter()
    res = serve_launch.main(argv)
    launcher_s = time.perf_counter() - t0
    cell = dict(res.mesh["timed"], tokens=res.out.cpu())
    stats = res.mesh["stats"]
    tokens_a = jrng.randint(jrng.PRNGKey(seed), (batch, check_prompt
                                                  + check_steps), 0,
                            cfg.vocab_size)
    names = [n for n in registry.all_arch_names()
             if registry.get(n).has_attention
             and registry.get(n).ssm_state == 0]
    smoke_cases = {}
    with pool.use(LM_DP_SHAPE) as run:
        run.call("load", cfg, seed=seed, max_seq=prompt + gen + 1)
        a = run.call("logits", tokens_a, check_steps, None, False)
        for name in names if smoke else []:
            scfg = registry.smoke_variant(name)
            cf = 16.0 if scfg.num_experts else None
            toks = jrng.randint(jrng.PRNGKey(seed), (4, 24 +
                                                     LM_MESH_SMOKE_STEPS),
                                0, scfg.vocab_size)
            cond = None
            if scfg.cross_attn_mode:
                cond = torch.randn((4, scfg.cond_len, scfg.cond_dim_),
                                   generator=torch.Generator().manual_seed(
                                       seed))
            run.call("load", scfg, seed=seed, capacity_factor=cf)
            got = run.call("logits", toks, LM_MESH_SMOKE_STEPS, cond, True)
            smoke_cases[name] = (scfg, toks, cond, got)
        run.call("release")
        transport = run.transport
    got = mesh_logical(torch, a["logits"], cfg, LM_DP_SHAPE)
    want = single_logits(torch, cfg, seed, tokens_a, check_steps, device)
    rel = row_rel(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not rel <= LM_MESH_TOL:
        raise AssertionError(f"{cfg.name} mesh logits differ from the single "
                             f"device by {rel:.4g} of the row's largest")
    smoke_out = {}
    for name, (scfg, toks, cond, res_s) in smoke_cases.items():
        if any(d for d, _ in res_s["drops"]):
            raise AssertionError(f"{name}: pairs dropped at factor 16")
        g = mesh_logical(torch, res_s["logits"], scfg, LM_DP_SHAPE)
        w = single_logits(torch, scfg, seed, toks, LM_MESH_SMOKE_STEPS,
                          device, cond, all_positions=True)
        err = row_rel(g, w)
        scale = w.abs().amax(-1, keepdim=True)
        if not bool(((g - w).abs() <= LM_RTOL * w.abs()
                     + LM_ATOL * scale).all()):
            raise AssertionError(f"{name}: mesh logits differ from the "
                                 f"single device by {err:.3g} of the row's "
                                 f"largest (rtol {LM_RTOL}, atol {LM_ATOL} "
                                 f"of it)")
        smoke_out[name] = {"max_rel_err": err}
    summary = {
        "arch": cfg.name, "layers": layers, "mesh": list(LM_DP_SHAPE),
        "transport": transport, "device": device, "batch": batch,
        "prompt": prompt, "gen": gen, "launcher_s": launcher_s,
        "launcher_generate_s": res.seconds,
        "param_bytes": param_bytes(cfg),
        **mesh_cell_summary(cell, stats, batch, gen, card),
        "check": {"prompt": check_prompt, "steps": check_steps,
                  "max_rel_err": rel, "tolerance": LM_MESH_TOL,
                  "argmax_agree": agree},
        "smoke_vs_single": smoke_out}
    log(f"[lm_mesh_dp] {card}: {cfg.name} ({layers} layers) {data} x {m} "
        f"({transport}): prefill {cell['prefill_ms']:.1f} ms, decode step "
        f"{summary['decode_step_ms_median']:.2f} ms median, "
        f"{summary['tokens_per_s']:.1f} tokens/s; collectives' share "
        f"prefill {summary['prefill_collective_share']:.3f}, decode "
        f"{summary['decode_collective_share']:.3f}; rank peak memory "
        f"{summary['rank_peak_mem_gb']} GB; logits vs one device {rel:.4g}")
    log(json.dumps({"lm_mesh_dp": summary}))
    return summary


# -- LM training on a device mesh ---------------------------------------------

LM_MT_SHAPE = (2, 2)              # data x model: 4 gloo ranks share the card
# deepseek's steps cut from 3 to 2 when the examples joined the script (its
# time; PERF.md section 4): the step median is the second step's
LM_MT_ARCH, LM_MT_LAYERS, LM_MT_STEPS = "deepseek-v2-lite-16b", 3, 2
LM_MT_DP_ARCH, LM_MT_DP_LAYERS, LM_MT_DP_STEPS = "gemma3-4b", 6, 2
LM_MT_BATCH, LM_MT_SEQ, LM_MT_MB = 4, 2048, 2
# check (a): float32, a capacity factor at which no pair drops (asserted:
# the single device's MoE drops none), a short sequence.  Level 2 of the
# expert-parallel path counts a source's empty buffer slots against local
# expert 0 (the reference's grouping), so with m = 2 model ranks a rank's
# second source reaches that expert only past cap1 - (its pairs) empty
# rows: the factor must be about E / m^2 = 16 for nothing to drop (at 4,
# 170 of 6,144 pairs dropped on the card; PERF.md).  At 16 the level-2
# buffers are [32, cap2, 2,048] float32 with cap2 = 6,160 at 256
# positions, and there a rank ran out of card memory in the backward
# (16.40 GiB allocated, 1.04 GiB more asked, the four ranks holding the
# whole card; PERF.md); at 128 positions cap2 is 3,088.
# (a) and (c) hold the CPU tests' tolerances (LM_LOSS_RTOL, LM_GRAD_RTOL,
# LM_GRAD_ATOL), and a parameter may also differ by as much as its
# gradient's tolerance can move AdamW's first step
# (``optimizer.first_step_band``: up to 2 lr where the tolerance spans
# 0), on at most LM_MT_FLIP_SHARE of a leaf
LM_MT_CHECK_SEQ, LM_MT_CHECK_CF = 128, 16.0
LM_MT_FLIP_SHARE = 0.02
LM_MT_LR = 3e-4


def stacked_tree(torch, named: dict) -> dict:
    """A model's ``{name: tensor}`` (its parameters, gradients or moments)
    as the JAX layout's flat tree, ``{'/'-path: tensor}``: a layer stack's
    leaves stacked to ``[L, ...]``, on their device."""
    from repro_torch.convert import LAYER_STACKS
    out, stacks = {}, {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in LAYER_STACKS:
            stacks.setdefault("/".join([parts[0]] + parts[2:]), {})[
                int(parts[1])] = t.detach()
        else:
            out["/".join(parts)] = t.detach()
    for path, layers in stacks.items():
        out[path] = torch.stack([layers[i] for i in range(len(layers))])
    return out


def tree_check(torch, got: dict, want: dict, what: str, band=None) -> dict:
    """Leaf by leaf, on ``want``'s device: ``got`` (flat numpy trees)
    within LM_GRAD_RTOL and LM_GRAD_ATOL of ``want``'s (flat tensor
    trees) largest; with ``band`` (the parameters'
    ``optimizer.first_step_band``) an element may also differ by its
    band, on at most LM_MT_FLIP_SHARE of a leaf.  Raises on a failure; returns the largest error over the
    leaf's largest and the elements that took their band."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: leaves {sorted(set(got) ^ set(want))}")
    worst, flips = 0.0, 0
    for path, w in want.items():
        w = w.float()
        g = torch.from_numpy(np.asarray(got[path], np.float32)).to(w.device)
        if g.shape != w.shape:
            raise AssertionError(f"{what} {path}: {tuple(g.shape)} against "
                                 f"{tuple(w.shape)}")
        scale = float(w.abs().max()) or 1.0
        diff = (g - w).abs()
        worst = max(worst, float(diff.max()) / scale)
        tol = LM_GRAD_ATOL * scale + LM_GRAD_RTOL * w.abs()
        bad = diff > tol
        if not bool(bad.any()):
            continue
        out = bad if band is None else diff > tol + band[path]
        share = float(bad.float().mean())
        if bool(out.any()) or share > LM_MT_FLIP_SHARE:
            i = int(torch.argmax(diff - tol))
            raise AssertionError(
                f"{what} {path}: {int(bad.sum())} of {bad.numel()} elements "
                f"off, {int(out.sum())} past their band; the worst: "
                f"{float(g.reshape(-1)[i])} against {float(w.reshape(-1)[i])}"
                + ("" if band is None else
                   f", band {float(band[path].reshape(-1)[i])}"))
        flips += int(bad.sum())
    return {"max_rel_err": worst, "band_elements": flips}


def single_train_arrays(torch, model, tc, batch: dict, device: str):
    """The single device's step on ``batch`` in its two halves
    (``loop.step_grads``, ``loop.apply_grads``), kind by kind as flat JAX
    trees of tensors on the card, each made when asked (``next``): first
    the gradient the step applies (the microbatches' float32
    accumulation) and the loss, then the metrics, then the parameters and
    moments after the step."""
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    args = batch_args(torch, batch, device)
    params = dict(model.named_parameters())
    state = train_loop.TrainState(model, opt.init(params))
    grads, metrics = train_loop.step_grads(state, max(tc.microbatch, 1),
                                           *args)
    yield {"grads": stacked_tree(torch, grads),
           "loss": float(metrics["loss"])}
    state, om = train_loop.apply_grads(state, grads, tc)
    del grads
    yield {"metrics": {k: float(v) for k, v in om.items()}}
    for kind, tree in (("params", params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        yield {kind: stacked_tree(torch, tree)}


def mesh_step_arrays(run, cfg, tc, batch: dict, **init) -> dict:
    """One mesh step on ``batch`` from ``init`` (``train_init``'s
    arguments), in its two halves (``train_grads``: ``loop.step_grads``;
    ``train_apply``: ``loop.apply_grads``): the
    gradient it applies, its metrics, the parameters and moments after
    it, as flat JAX trees (numpy, logical), and each call's seconds."""
    secs = {}

    def timed(name, *args, **kw):
        t = time.perf_counter()
        out = run.call(name, *args, **kw)
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t
        return out

    from repro_torch import convert
    run.call("reset_peak")
    timed("train_init", cfg, tc, **init)
    out = {"grad_metrics": timed("train_grads", batch)}
    t = time.perf_counter()
    out["grads"] = convert.flat_tree(run.arrays(cfg, "grads")["grads"])
    secs["gather_grads"] = time.perf_counter() - t
    if out["grad_metrics"].get("dropped"):
        raise AssertionError(f"{cfg.name}: {out['grad_metrics']['dropped']} "
                             f"(token, expert) pairs dropped at capacity "
                             f"factor {cfg.capacity_factor}")
    out["metrics"] = dict(timed("train_apply"),
                          loss=out["grad_metrics"]["loss"])
    out["rank_peak_mem_gb"] = [
        None if r["max_memory_allocated"] is None
        else r["max_memory_allocated"] / 1e9 for r in run.call("stats")]
    t = time.perf_counter()
    out.update({k: convert.flat_tree(v) for k, v in
                run.arrays(cfg, "params", "m", "v").items()})
    secs["gather_state"] = time.perf_counter() - t
    run.call("release")
    out["seconds"] = secs
    return out


def mesh_vs_single(torch, mesh: dict, model, tc, batch: dict, device: str,
                   what: str) -> dict:
    """Check a mesh step (``mesh_step_arrays``) against the single
    device's (``single_train_arrays``) on the same logical weights: the
    loss (LM_LOSS_RTOL), the grad norm, the gradient, both moments and
    the parameters (``tree_check``); kinds freed as they are held."""
    from repro_torch.train import optimizer as opt
    steps = single_train_arrays(torch, model, tc, batch, device)
    first = next(steps)
    out = {"loss": mesh["grad_metrics"]["loss"], "loss_single": first["loss"],
           "pairs": mesh["grad_metrics"].get("pairs"),
           "rank_peak_mem_gb": mesh["rank_peak_mem_gb"],
           "mesh_call_s": mesh["seconds"]}
    got = mesh["grad_metrics"]["loss"]
    if not abs(got - first["loss"]) <= LM_LOSS_RTOL * abs(first["loss"]):
        raise AssertionError(f"{what}: mesh loss {got} against one "
                             f"device's {first['loss']}")
    grads = first["grads"]
    out["grads"] = tree_check(torch, mesh.pop("grads"), grads,
                              f"{what} gradient")
    met = next(steps)["metrics"]
    gn, want_gn = mesh["metrics"]["grad_norm"], met["grad_norm"]
    if not abs(gn - want_gn) <= LM_GRAD_RTOL * want_gn:
        raise AssertionError(f"{what}: grad norm {gn} against {want_gn}")
    out["grad_norm"], out["grad_norm_single"] = gn, want_gn
    clip = min(1.0, tc.grad_clip / max(want_gn, 1e-9))
    band = {n: opt.first_step_band(g, clip, met["lr"], tc.eps,
                                   LM_GRAD_RTOL, LM_GRAD_ATOL)
            for n, g in grads.items()}
    del grads, first
    for kinds in steps:
        (kind, want), = kinds.items()
        out[kind] = tree_check(torch, mesh.pop(kind), want, f"{what} {kind}",
                               band if kind == "params" else None)
        del want, kinds
    return out


def mesh_train_flops(cfg, batch: int, seq: int) -> int:
    """FLOPs a training step must do: forward and backward (6 a weight and
    token) of every non-expert matmul weight, of the top-k routed experts
    a token and of the head over every position, and of attention over
    the causal pairs (4 a pair and head dim forward, 12 in all).  Remat's
    second forward and the expert-parallel path's capacity padding are
    not counted: work the bound need not do."""
    from repro_torch.models import transformer as tfm
    model = tfm.Transformer(cfg, device="meta")
    fe = cfg.moe_d_ff or cfg.d_ff
    moe_layers = sum(1 for _, _, b, _, _ in model.schedule()
                     if hasattr(b, "moe"))
    dense_w = sum(p.numel() for n, p in model.named_parameters()
                  if p.dim() >= 2 and ".experts." not in n
                  and "table" not in n)
    active = (dense_w + moe_layers * cfg.top_k * 3 * cfg.d_model * fe
              + cfg.d_model * cfg.vocab_size)
    if cfg.use_mla:
        qk, v = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    else:
        qk = v = cfg.head_dim_
    attn = sum(6 * batch * cfg.num_heads * (qk + v) * sum(
        min(q + 1, w) if w else q + 1 for q in range(seq))
        for w in cfg.windows())
    return 6 * batch * seq * active + attn + 3 * ssd_flops(cfg, batch * seq)


def mesh_train_cell(torch, run, cfg, tc, batches, card: str) -> dict:
    """One training cell on the mesh: ``fit`` from the seed's weights over
    ``batches`` (check (b): finite losses and grad norms, every rank's
    parameter and moment blocks moved), then step ms (the median over
    the steps after the first), tokens/s, each rank's peak memory, the
    collectives by tag (rank 0's ms, bytes and calls a step) and their
    share of the steps' time, the dropped share, and the bound: the
    step's FLOPs at 989 TFLOP/s plus the optimizer's bytes at 3.35 TB/s
    (the card does every rank's work)."""
    init = run.call("train_init", cfg, tc, seed=tc.seed)
    res = run.call("train_fit", batches, 1)
    run.call("release")
    batch, seq = batches[0]["tokens"].shape
    return train_cell_summary(cfg, tc, init, res["history"], res["ranks"],
                              LM_MT_SHAPE, batch, seq, card)


def train_cell_summary(cfg, tc, init: dict, hist: list, ranks: list, shape,
                       batch: int, seq: int, card: str) -> dict:
    """A training cell's numbers from ``op_train_init``'s result and
    ``op_train_fit``'s history (a step logged each step) and ranks: see
    ``mesh_train_cell``."""
    from repro_torch.models import transformer as tfm
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"{cfg.name}: step {h['step']} loss "
                                 f"{h['loss']} grad norm {h['grad_norm']}")
    for r, rk in enumerate(ranks):
        if rk["unmoved_params"] or rk["unmoved_moments"]:
            raise AssertionError(
                f"{cfg.name}: rank {r} blocks that did not move: "
                f"{rk['unmoved_params'][:4]} {rk['unmoved_moments'][:4]}")
    ends = [h["elapsed_s"] * 1e3 for h in hist]
    step_ms = [b - a for a, b in zip(ends, ends[1:])]
    ms = float(np.median(step_ms))
    steps = len(hist)
    coll = ranks[0]["collectives"]
    coll_ms = sum(c["ms"] for c in coll.values())
    kinds = {}
    for tag, c in coll.items():
        kind = tag.split(".")[0] + (".grad" if ".grad" in tag else "")
        k = kinds.setdefault(kind, {"ms": 0.0, "bytes": 0, "calls": 0})
        for f in k:
            k[f] += c[f] / steps
    drops = [sum(r["drops"][i][0] for r in ranks) for i in
             range(len(ranks[0]["drops"]))]
    pairs = [sum(r["drops"][i][1] for r in ranks) for i in
             range(len(ranks[0]["drops"]))]
    flops = mesh_train_flops(cfg, batch, seq)
    model = tfm.Transformer(cfg, device="meta")
    nbytes = lm_train_bytes(model, max(tc.microbatch, 1))
    bound = flops / BF16_FLOPS * 1e3 + nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "arch": cfg.name, "layers": cfg.num_layers, "mesh": list(shape),
        "dtype": cfg.dtype, "remat": cfg.remat, "batch": batch, "seq": seq,
        "microbatch": tc.microbatch, "steps": steps,
        "capacity_factor": cfg.capacity_factor if cfg.num_experts else None,
        "params": sum(p.numel() for p in model.parameters()),
        "rank_param_gb": init["param_bytes"] / 1e9,
        "rank_moment_gb": init["moment_bytes"] / 1e9,
        "init_s": init["load_s"],
        "loss": [h["loss"] for h in hist],
        "grad_norm": [h["grad_norm"] for h in hist],
        "step_ms": step_ms, "step_ms_median": ms,
        "first_step_ms": ends[0], "tokens_per_s": batch * seq / ms * 1e3,
        "rank_peak_mem_gb": [None if r["max_memory_allocated"] is None
                             else r["max_memory_allocated"] / 1e9
                             for r in ranks],
        "collectives_ms_per_step": coll_ms / steps,
        "collectives_gb_per_step": sum(c["bytes"] for c in coll.values())
        / steps / 1e9,
        "collectives_share": coll_ms / ends[-1],
        "collectives_by_kind": kinds,
        "collectives_by_tag": coll,
        "dropped_share": sum(drops) / max(sum(pairs), 1),
        "flops": flops, "optimizer_bytes": nbytes, "bound_ms": bound,
        "bound_share": bound / ms, "card": card}


def lm_mesh_train(torch, seed: int, card: str, device: str = "cuda",
                  smoke: bool = False, seq: int = LM_MT_SEQ,
                  check_seq: int = LM_MT_CHECK_SEQ,
                  names: Optional[list] = None,
                  pool: Optional[MeshPool] = None) -> dict:
    """LM training on a data 2 x model 2 mesh of gloo ranks sharing the
    card (``train.mesh_worker``), right after the serving mesh phases.
    (a) deepseek-v2-lite-16b at full width, depth 3 (the dense layer and
    two MoE layers), float32, batch 4 x ``check_seq``, microbatch 2,
    capacity factor 16 (no pair dropped, asserted): one mesh step's loss, gradient (each rank's ZeRO
    slices gathered to logical), moments and parameters against the
    single-device step of the same seed on the card, run after the mesh
    has gone.  Then the cells in bf16 from the seed: deepseek (3 layers,
    capacity factor 1.25, 3 steps) and gemma3-4b (full width, 6 layers,
    2 steps), batch 4 x ``seq``, microbatch 2, remat on; (b) finite
    losses and grad norms, every block moved; step ms, tokens/s, peak
    memory a rank, the collectives and the bound.  (c) the eight
    attention archs' smoke variants (float32, remat, capacity factor 16)
    on the mesh against one device on the card.  One mesh (``pool``'s)
    serves (a), the cells and (c); the single device's halves of (a) and
    (c) run after it, its ranks idle, their models released.  ``smoke`` (a
    CPU rehearsal) runs the cells at the smoke variants' widths."""
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
    from repro_torch.models import transformer as tfm

    pool = pool or MeshPool(torch, device, keep=False)

    def get(name, layers):
        c = registry.smoke_variant(name) if smoke else registry.get(name)
        return dataclasses.replace(c, num_layers=layers, remat=True)

    def batches(cfg, n, s, sd):
        return list(MarkovZipfSource(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=s, batch_size=LM_MT_BATCH,
            seed=sd)).batches(n))

    ds = get(LM_MT_ARCH, LM_MT_LAYERS)
    if not smoke and (ds.d_model, ds.num_heads, ds.use_mla, ds.num_experts,
                      ds.top_k, ds.num_shared_experts, ds.vocab_size,
                      ds.dtype, ds.first_dense_layers) != (
            2048, 16, True, 64, 6, 2, 102_400, "bfloat16", 1):
        raise AssertionError(f"not deepseek-v2-lite-16b's widths: {ds}")
    gemma = get(LM_MT_DP_ARCH, LM_MT_DP_LAYERS)
    summary = {"card": card, "mesh": list(LM_MT_SHAPE)}

    # one mesh for (a)'s mesh half, the cells (b) and (c)'s mesh halves;
    # then, its models released, the single device's halves
    ds32 = dataclasses.replace(ds, dtype="float32",
                               capacity_factor=LM_MT_CHECK_CF)
    tc_a = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       microbatch=LM_MT_MB, seed=seed)
    batch_a = batches(ds32, 1, check_seq, seed + 1)[0]
    tc = {n: TrainConfig(learning_rate=LM_MT_LR, warmup_steps=1,
                         total_steps=s, microbatch=LM_MT_MB, seed=seed)
          for n, s in ((ds.name, LM_MT_STEPS), (gemma.name, LM_MT_DP_STEPS))}
    archs = names if names is not None else [
        n for n in registry.all_arch_names()
        if registry.get(n).has_attention and registry.get(n).ssm_state == 0]
    smoke_cases = {}
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with pool.use(LM_MT_SHAPE) as run:
        transport = run.transport
        t = time.perf_counter()
        mesh_a = mesh_step_arrays(run, ds32, tc_a, batch_a, seed=seed)
        mesh_a_s = time.perf_counter() - t
        cells = {}
        for cfg, steps in ((ds, LM_MT_STEPS), (gemma, LM_MT_DP_STEPS)):
            t = time.perf_counter()
            cells[cfg.name] = mesh_train_cell(
                torch, run, cfg, tc[cfg.name],
                batches(cfg, steps, seq, seed + 2), card)
            cells[cfg.name]["cell_s"] = time.perf_counter() - t
        for name in archs:
            scfg = dataclasses.replace(registry.smoke_variant(name),
                                       remat=True)
            if scfg.num_experts:
                scfg = dataclasses.replace(scfg,
                                           capacity_factor=LM_MT_CHECK_CF)
            ref = tfm.init_params(seed, scfg, device="cpu")
            perturb_constants(torch, ref, seed)
            params = convert.lm_arrays_from_params(ref)
            del ref
            b = smoke_batch(scfg, seed, batch=4, seq=24)
            smoke_cases[name] = (scfg, params, b, mesh_step_arrays(
                run, scfg, tc_a, b, params=params))
    mesh_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    single = tfm.init_params(seed, ds32, device=device)
    check_a = mesh_vs_single(torch, mesh_a, single, tc_a, batch_a, device,
                             f"{ds.name} float32")
    del single, mesh_a
    if device == "cuda":
        torch.cuda.empty_cache()
    summary["check_a"] = dict(check_a, arch=ds.name, layers=ds.num_layers,
                              seq=check_seq, capacity_factor=LM_MT_CHECK_CF,
                              mesh_s=mesh_a_s,
                              single_s=time.perf_counter() - t1)
    log(f"[lm_mesh_train] {card}: check (a) {ds.name} float32 mesh = one "
        f"device: loss {check_a['loss']:.6f} / {check_a['loss_single']:.6f}"
        f", gradient {check_a['grads']['max_rel_err']:.3g}, m "
        f"{check_a['m']['max_rel_err']:.3g}, v "
        f"{check_a['v']['max_rel_err']:.3g}, params "
        f"{check_a['params']['max_rel_err']:.3g} of the leaf's largest "
        f"({check_a['params']['band_elements']} elements in their first-"
        f"step band)")
    smoke_out = {}
    for name, (scfg, params, b, mesh) in smoke_cases.items():
        model = convert.lm_params_from_arrays(params, scfg, device=device)
        smoke_out[name] = mesh_vs_single(torch, mesh, model, tc_a, b,
                                         device, name)
    summary.update({
        "transport": transport, "device": device,
        "deepseek": cells[ds.name], "gemma3_4b": cells[gemma.name],
        "check_c": smoke_out, "mesh_s": mesh_s})
    for key in ("deepseek", "gemma3_4b"):
        c = summary[key]
        log(f"[lm_mesh_train] {card}: {c['arch']} {c['layers']} layers "
            f"{LM_MT_SHAPE[0]} x {LM_MT_SHAPE[1]} ({transport}): step "
            f"{c['step_ms_median']:.1f} ms median ({c['step_ms']}), first "
            f"{c['first_step_ms']:.1f} ms, {c['tokens_per_s']:.1f} tokens/s "
            f"(bound {c['bound_ms']:.2f} ms); collectives "
            f"{c['collectives_ms_per_step']:.1f} ms and "
            f"{c['collectives_gb_per_step']:.2f} GB a step on rank 0, share "
            f"{c['collectives_share']:.3f}; peak {c['rank_peak_mem_gb']} GB"
            f"; loss {c['loss']}; dropped share {c['dropped_share']:.4f}")
    log(f"[lm_mesh_train] {card}: check (c) the smoke archs' mesh step = one "
        f"device: worst gradient "
        f"{max(v['grads']['max_rel_err'] for v in smoke_out.values()):.3g}"
        f", params "
        f"{max(v['params']['max_rel_err'] for v in smoke_out.values()):.3g}"
        f" of the leaf's largest")
    log(json.dumps({"lm_mesh_train": summary}))
    return summary


# -- the SSM families on a model axis, the sequence-sharded decode cache ------

LM_SSM_ARCH, LM_HY_ARCH = "mamba2-370m", "hymba-1.5b"
LM_SSM_SERVE_SHAPE, LM_SSM_TRAIN_SHAPE = (1, 4), (2, 2)
LM_HY_SHAPE = (2, 2)               # "heads" SSM, "gather" attention
# cut to fit the script's time beside the earlier mesh cells (PERF.md
# section 4; whole-script runs were slower than a phase alone by up to 2x,
# gloo's calls): mamba2-370m's tokens from 64 to 8 and its training depth
# from 48 to 8 layers (to 4 when the examples joined the script) and steps
# from 3 to 2; hymba-1.5b's serving depth from 32 to 4 (layer 0, global,
# kept) and tokens from 32 to 8, its training depth to 2
LM_SSM_BATCH, LM_SSM_PROMPT, LM_SSM_GEN = 4, 2048, 8
LM_SSM_TRAIN_LAYERS, LM_HY_SERVE_LAYERS, LM_HY_TRAIN_LAYERS = 4, 4, 2
LM_HY_GEN = 8
LM_SSM_SEQ, LM_SSM_MB, LM_SSM_STEPS, LM_HY_STEPS = 2048, 2, 2, 2
# check (c): mamba2-370m in float32 on 1 x 4 against one device, the
# prompt and LM_CHECK_STEPS decode steps (LM_MESH_TOL), and one train step
# at 4 x LM_SSM_CHECK_SEQ (lm_mesh_train's check (a) tolerances)
LM_SSM_CHECK_SEQ = 128
# the sequence-sharded cache: gemma3-4b at full width, one 5 local : 1
# global period (6 layers), and hymba-1.5b, batch 1 on 2 x 2.  long_500k's
# 524,288 slots cut by 16 and the prompt to 24,576: four ranks share one
# card and each data rank runs the whole prompt (the reference replicates
# a batch the dp axes cannot fill), and the script's time (PERF.md
# section 4); the global layer still reads both data ranks' blocks of
# 16,384 slots, the window-1,024 layers one rank's
LM_LONG_SHAPE, LM_LONG_LAYERS = (2, 2), 6
# cut to fit the script's time (PERF.md section 4): the tokens from 32 to
# 16, hymba-1.5b's depth from 32 to 2 (layer 0, global, and a window
# layer): at 32 its prefill took 127 s at a 98,304 prompt
LM_LONG_HY_LAYERS = 2
LM_LONG_SLOTS, LM_LONG_PROMPT, LM_LONG_GEN = 32_768, 24_576, 16
LM_LONG_CHECK_SLOTS, LM_LONG_CHECK_PROMPT = 8192, 6144


def full_config(cfg, want: tuple) -> None:
    """Raise unless ``cfg`` has the published widths ``want``: (layers,
    d_model, heads, kv heads, SSD heads, SSM state, vocab, dtype)."""
    got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.ssm_heads if cfg.ssm_state else 0, cfg.ssm_state,
           cfg.vocab_size, cfg.dtype)
    if got != want:
        raise AssertionError(f"not {cfg.name}'s full config: {got}")


def ssm_decode_bytes(cfg, batch: int, pos: int, dp: int = 1) -> int:
    """Bytes a decode step at ``pos`` must move: every weight once, each
    SSM layer's state read and written (float32) and conv tail read, and
    each attention layer's K and V over its live slots (``lm_decode_bytes``'
    count); ``dp`` data ranks that each hold the whole batch read the
    weights and states ``dp`` times (a replicated batch's work: not the
    function's bound, reported beside it)."""
    from repro_torch.models.attention import live_range
    n = param_bytes(cfg) * dp
    it = 2 if cfg.dtype == "bfloat16" else 4
    if cfg.ssm_state:
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        tail = (cfg.ssm_conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
        n += dp * cfg.num_layers * batch * (2 * state + tail * it)
    if cfg.has_attention:
        slot = cfg.num_kv_heads * cfg.head_dim_ * 2 * it
        for w in cfg.windows():
            lo, hi = live_range(pos, w)
            n += batch * (hi - lo) * slot
    return n


def serve_cell_summary(cfg, cell: dict, stats: list, transport: str, shape,
                       batch: int, prompt: int, gen: int, card: str) -> dict:
    """A serving cell's numbers from ``op_generate(timed=True)``'s result
    (its tokens checked) and ``op_stats``': rank 0's prefill and decode step ms and
    collectives, each rank's peak memory (``mesh_cell_summary``), and the
    bounds: prefill's FLOPs at 989 TFLOP/s (``mesh_flops``), a decode
    step's bytes at 3.35 TB/s (``ssm_decode_bytes``)."""
    out = cell["tokens"]
    if tuple(out.shape) != (batch, gen) or int(out.min()) < 0 or \
            int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: tokens {tuple(out.shape)} out of "
                             "range")
    fl = mesh_flops(cfg, batch, prompt, shape, cfg.capacity_factor)
    nbytes = ssm_decode_bytes(cfg, batch, prompt + gen // 2)
    return {"arch": cfg.name, "layers": cfg.num_layers, "mesh": list(shape),
            "transport": transport, "batch": batch, "prompt": prompt,
            "gen": gen, "params": cfg.param_count(),
            "param_bytes": param_bytes(cfg),
            **mesh_cell_summary(cell, stats, batch, gen, card),
            "prefill_flops_needed": fl["need"],
            "prefill_bound_ms": fl["need"] / BF16_FLOPS * 1e3,
            "decode_bound_bytes": nbytes,
            "decode_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def serve_launch_cell(torch, cfg, argv: list, shape, batch: int,
                      prompt: int, gen: int, card: str) -> dict:
    """One serving cell through ``repro_torch.launch.serve``'s main on a
    mesh (``--mesh host``): ``serve_cell_summary`` of its timed parts."""
    from repro_torch.launch import serve as serve_launch
    t0 = time.perf_counter()
    res = serve_launch.main(argv)
    cell = dict(res.mesh["timed"], tokens=res.out)
    return dict(serve_cell_summary(cfg, cell, res.mesh["stats"],
                                   res.mesh["transport"], shape, batch,
                                   prompt, gen, card),
                launcher_s=time.perf_counter() - t0,
                launcher_generate_s=res.seconds,
                mesh_start_s=res.mesh["start_s"], load_s=res.mesh["load_s"])


def train_launch_cell(torch, cfg, argv: list, shape, batch: int, seq: int,
                      card: str) -> dict:
    """One training cell through ``repro_torch.launch.train``'s main on a
    mesh (a step logged each step): ``train_cell_summary``'s checks and
    numbers."""
    from repro_torch.launch import train as train_launch
    t0 = time.perf_counter()
    res = train_launch.main(argv)
    out = train_cell_summary(cfg, res.tc, res.mesh["init"], res.history,
                             res.mesh["ranks"], shape, batch, seq, card)
    out.update(transport=res.mesh["transport"],
               launcher_s=time.perf_counter() - t0,
               mesh_start_s=res.mesh["start_s"])
    return out


def log_serve_cell(tag: str, c: dict, card: str) -> None:
    calls = sum(v["calls"] for v in
                c["decode_collectives_per_step"]["by_tag"].values())
    log(f"[{tag}] {card}: {c['arch']} ({c['layers']} layers) "
        f"{c['mesh'][0]} x {c['mesh'][1]} ({c['transport']}) serving "
        f"{c['batch']} x {c['prompt']}: prefill {c['prefill_ms']:.1f} ms "
        f"(bound {c['prefill_bound_ms']:.2f}), decode step "
        f"{c['decode_step_ms_median']:.2f} ms median (bound "
        f"{c['decode_bound_ms']:.3f}), {c['tokens_per_s']:.1f} tokens/s; "
        f"collectives' share prefill {c['prefill_collective_share']:.3f}, "
        f"decode {c['decode_collective_share']:.3f} ("
        f"{c['decode_collectives_per_step']['ms']:.1f} ms, "
        f"{calls:.0f} calls a step); rank peak memory "
        f"{c['rank_peak_mem_gb']} GB")


def log_train_cell(tag: str, c: dict, card: str) -> None:
    log(f"[{tag}] {card}: {c['arch']} ({c['layers']} layers) "
        f"{c['mesh'][0]} x {c['mesh'][1]} ({c['transport']}) training "
        f"{c['batch']} x {c['seq']}, microbatch {c['microbatch']}: step "
        f"{c['step_ms_median']:.1f} ms median ({c['step_ms']}), "
        f"{c['tokens_per_s']:.1f} tokens/s (bound {c['bound_ms']:.2f} ms); "
        f"collectives {c['collectives_ms_per_step']:.1f} ms and "
        f"{c['collectives_gb_per_step']:.2f} GB a step, share "
        f"{c['collectives_share']:.3f}; peak {c['rank_peak_mem_gb']} GB; "
        f"loss {c['loss']}")


def lm_mesh_ssm(torch, seed: int, card: str, device: str = "cuda",
                layers: int = 0, train_layers: int = LM_SSM_TRAIN_LAYERS,
                hymba_layers: int = LM_HY_SERVE_LAYERS,
                hymba_train_layers: int = LM_HY_TRAIN_LAYERS,
                batch: int = LM_SSM_BATCH, prompt: int = LM_SSM_PROMPT,
                gen: int = LM_SSM_GEN, hymba_gen: int = LM_HY_GEN,
                seq: int = LM_SSM_SEQ,
                check_prompt: int = LM_MESH_CHECK_PROMPT,
                check_steps: int = LM_CHECK_STEPS,
                check_seq: int = LM_SSM_CHECK_SEQ,
                pool: Optional[MeshPool] = None) -> dict:
    """The SSM families on a model axis above 1, 4 gloo ranks sharing the
    card.  (a) mamba2-370m at full width (d_model 1,024, 32 SSD heads,
    state 128, vocab 50,280, bf16): served at its 48 layers (``layers``
    cuts them for a CPU rehearsal) on data 1 x model 4 (8 heads a rank)
    through ``launch.serve --mesh host``, batch 4, prompt 2,048, ``gen``
    greedy tokens; trained at ``train_layers`` on 2 x 2 through
    ``launch.train --mesh host``, 4 x 2,048, microbatch 2, remat, 2 steps.
    (b) hymba-1.5b at full width on one 2 x 2 mesh ("heads" SSM, "gather"
    attention, the sequence-parallel prefill): served at
    ``hymba_layers``, batch 4, prompt 2,048, ``hymba_gen`` tokens; trained
    at ``hymba_train_layers``, 4 x 2,048, microbatch 2, 2 steps (layer 0,
    global, kept in both).  (c) mamba2-370m as served, in float32, on 1 x
    4 against one device from the same seed, its mesh idle: the prefill's
    and ``check_steps`` teacher-forced decode steps' logits (LM_MESH_TOL),
    one train step's loss, gradient, moments and parameters
    (``mesh_vs_single``).  (c) runs before (b), so that (b)'s mesh, from
    ``pool``, stays open for the next phase of its shape."""
    from repro_torch import rng as jrng
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
    from repro_torch.models import transformer as tfm

    pool = pool or MeshPool(torch, device, keep=False)
    pool.close()                 # the launchers' rank 0 is this process

    mamba, hymba = registry.get(LM_SSM_ARCH), registry.get(LM_HY_ARCH)
    full_config(mamba, (48, 1024, 0, 0, 32, 128, 50_280, "bfloat16"))
    full_config(hymba, (32, 1600, 25, 5, 50, 16, 32_001, "bfloat16"))
    if layers:
        mamba = dataclasses.replace(mamba, num_layers=layers)
    mamba_t = dataclasses.replace(mamba, num_layers=min(train_layers,
                                                        mamba.num_layers))
    hymba_s, hymba_t = (dataclasses.replace(hymba, num_layers=n)
                        for n in (hymba_layers, hymba_train_layers))
    common = ["--seed", str(seed), "--device", device, "--mesh", "host"]
    summary = {"card": card}

    def batches(cfg, n):
        return list(MarkovZipfSource(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
            seed=seed)).batches(n))

    # (a) through the launchers
    t = time.perf_counter()
    data, m = LM_SSM_SERVE_SHAPE
    summary["mamba_serve"] = serve_launch_cell(
        torch, mamba, ["--arch", LM_SSM_ARCH, "--layers",
                       str(mamba.num_layers), "--batch", str(batch),
                       "--prompt-len", str(prompt), "--gen", str(gen),
                       *common, "--devices", str(data * m), "--mesh-model",
                       str(m)],
        LM_SSM_SERVE_SHAPE, batch, prompt, gen, card)
    summary["mamba_serve"]["cell_s"] = time.perf_counter() - t
    t = time.perf_counter()
    data, m = LM_SSM_TRAIN_SHAPE
    summary["mamba_train"] = train_launch_cell(
        torch, mamba_t, ["--arch", LM_SSM_ARCH, "--layers",
                         str(mamba_t.num_layers), "--batch", str(batch),
                         "--seq", str(seq), "--microbatch", str(LM_SSM_MB),
                         "--steps", str(LM_SSM_STEPS), "--log-every", "1",
                         "--lr", str(LM_MT_LR), "--out", "", *common,
                         "--devices", str(data * m), "--mesh-model", str(m)],
        LM_SSM_TRAIN_SHAPE, batch, seq, card)
    summary["mamba_train"]["cell_s"] = time.perf_counter() - t

    # (c) float32 on 1 x 4 against one device
    cfg32 = dataclasses.replace(mamba, dtype="float32")
    tokens_c = jrng.randint(jrng.PRNGKey(seed), (batch, check_prompt
                                                  + check_steps), 0,
                            mamba.vocab_size)
    tc_c = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       microbatch=LM_SSM_MB, seed=seed)
    batch_c = next(MarkovZipfSource(LMDataConfig(
        vocab_size=mamba.vocab_size, seq_len=check_seq, batch_size=batch,
        seed=seed + 1)).batches(1))
    t = time.perf_counter()
    with pool.use(LM_SSM_SERVE_SHAPE) as run:
        run.call("load", cfg32, seed=seed)
        logits_c = run.call("logits", tokens_c, check_steps, None, False)
        run.call("release")
        mesh_c = mesh_step_arrays(run, cfg32, tc_c, batch_c, seed=seed)
    mesh_s = time.perf_counter() - t
    t = time.perf_counter()
    got = mesh_logical(torch, logits_c["logits"], cfg32, LM_SSM_SERVE_SHAPE)
    want = single_logits(torch, cfg32, seed, tokens_c, check_steps, device)
    rel = row_rel(got, want)
    if not rel <= LM_MESH_TOL:
        raise AssertionError(f"{mamba.name} float32 mesh logits differ from "
                             f"one device by {rel:.4g} of the row's largest")
    single = tfm.init_params(seed, cfg32, device=device)
    check = mesh_vs_single(torch, mesh_c, single, tc_c, batch_c, device,
                           f"{mamba.name} float32")
    del single, mesh_c
    if device == "cuda":
        torch.cuda.empty_cache()
    summary["check_c"] = dict(
        check, arch=mamba.name, layers=mamba.num_layers,
        mesh=list(LM_SSM_SERVE_SHAPE), prompt=check_prompt,
        steps=check_steps, logits_max_rel_err=rel,
        logits_tolerance=LM_MESH_TOL,
        argmax_agree=float((got.argmax(-1) == want.argmax(-1)).float()
                           .mean()),
        seq=check_seq, mesh_s=mesh_s, single_s=time.perf_counter() - t)

    # (b) one mesh serves and trains hymba
    t = time.perf_counter()
    tc_b = TrainConfig(learning_rate=LM_MT_LR, warmup_steps=1,
                       total_steps=LM_HY_STEPS, microbatch=LM_SSM_MB,
                       seed=seed)
    prompts = jrng.randint(jrng.PRNGKey(seed), (batch, prompt), 0,
                           hymba.vocab_size)
    with pool.use(LM_HY_SHAPE) as run:
        transport = run.transport
        run.call("load", hymba_s, seed=seed, max_seq=prompt + hymba_gen + 1)
        run.call("reset_peak")
        cell = run.call("generate", prompts, hymba_gen, timed=True)
        stats = run.call("stats")
        run.call("release")
        serve_s = time.perf_counter() - t
        init = run.call("train_init", hymba_t, tc_b, seed=seed)
        fit = run.call("train_fit", batches(hymba_t, LM_HY_STEPS), 1)
        run.call("release")
    summary["hymba_serve"] = dict(serve_cell_summary(
        hymba_s, cell, stats, transport, LM_HY_SHAPE, batch, prompt,
        hymba_gen, card), cell_s=serve_s)
    summary["hymba_train"] = dict(train_cell_summary(
        hymba_t, tc_b, init, fit["history"], fit["ranks"], LM_HY_SHAPE,
        batch, seq, card), transport=transport,
        cell_s=time.perf_counter() - t - serve_s)
    for key in ("mamba_serve", "hymba_serve"):
        log_serve_cell("lm_mesh_ssm", summary[key], card)
    for key in ("mamba_train", "hymba_train"):
        log_train_cell("lm_mesh_ssm", summary[key], card)
    c = summary["check_c"]
    log(f"[lm_mesh_ssm] {card}: check (c) {mamba.name} float32 1 x 4 = one "
        f"device: logits {rel:.4g} of the row's largest (tol "
        f"{LM_MESH_TOL:.4g}); train step loss {c['loss']:.6f} / "
        f"{c['loss_single']:.6f}, gradient {c['grads']['max_rel_err']:.3g},"
        f" m {c['m']['max_rel_err']:.3g}, v {c['v']['max_rel_err']:.3g}, "
        f"params {c['params']['max_rel_err']:.3g} of the leaf's largest "
        f"({c['params']['band_elements']} elements in their first-step "
        f"band)")
    log(json.dumps({"lm_mesh_ssm": summary}))
    return summary


def lm_mesh_long(torch, seed: int, card: str, device: str = "cuda",
                 layers: int = LM_LONG_LAYERS,
                 hymba_layers: int = LM_LONG_HY_LAYERS,
                 slots: int = LM_LONG_SLOTS, prompt: int = LM_LONG_PROMPT,
                 gen: int = LM_LONG_GEN,
                 check_slots: int = LM_LONG_CHECK_SLOTS,
                 check_prompt: int = LM_LONG_CHECK_PROMPT,
                 check_steps: int = LM_CHECK_STEPS,
                 widths: bool = True,
                 pool: Optional[MeshPool] = None) -> dict:
    """The sequence-sharded decode cache, batch 1 on data 2 x model 2 (4
    gloo ranks sharing the card; every data rank runs the whole prompt
    and holds its half of each attention cache's slots).  (d) gemma3-4b
    at full width, ``layers`` (one 5 local : 1 global period), a cache of
    ``slots``, a prompt of ``prompt`` and ``gen`` greedy tokens: the
    global layer reads both data ranks' blocks, the window-1,024 layers one
    rank's.  (e) hymba-1.5b at full width, the same batch, cache, prompt
    and tokens (``hymba_layers`` cuts its depth, keeping layer 0, which is
    global).  (f) gemma3-4b in float32, the same layers, ``check_slots``
    slots, a prompt of ``check_prompt`` and ``check_steps`` teacher-forced
    decode steps against one device (LM_MESH_TOL), every rank's logits the
    same bits.  ``widths=False`` (a CPU rehearsal) runs smoke widths.  The
    mesh is ``pool``'s: the one lm_mesh_ssm's (b) left open."""
    from repro_torch import rng as jrng
    from repro_torch.configs import registry

    pool = pool or MeshPool(torch, device, keep=False)

    get = registry.get if widths else registry.smoke_variant
    gemma = dataclasses.replace(get("gemma3-4b"), num_layers=layers)
    hymba = get(LM_HY_ARCH)
    if hymba_layers:
        hymba = dataclasses.replace(hymba, num_layers=hymba_layers)
    if widths:
        full_config(gemma, (layers, 2560, 8, 4, 0, 0, 262_144, "bfloat16"))
        if not hymba_layers:
            full_config(hymba, (32, 1600, 25, 5, 50, 16, 32_001,
                                "bfloat16"))
    data, m = LM_LONG_SHAPE
    gemma32 = dataclasses.replace(gemma, dtype="float32")
    tokens_f = jrng.randint(jrng.PRNGKey(seed), (1, check_prompt
                                                  + check_steps), 0,
                            gemma.vocab_size)
    cells = {}
    t0 = time.perf_counter()
    with pool.use(LM_LONG_SHAPE) as run:
        transport = run.transport
        for key, cfg in (("gemma3_4b", gemma), ("hymba", hymba)):
            t = time.perf_counter()
            prompts = jrng.randint(jrng.PRNGKey(seed + 1), (1, prompt), 0,
                                   cfg.vocab_size)
            run.call("load", cfg, seed=seed, max_seq=slots)
            run.call("reset_peak")
            cell = run.call("generate", prompts, gen, timed=True)
            stats = run.call("stats")
            run.call("release")
            cells[key] = (cfg, cell, stats, time.perf_counter() - t)
        t = time.perf_counter()
        run.call("load", gemma32, seed=seed)
        f = run.call("logits", tokens_f, check_steps, None, False,
                     max_seq=check_slots, per_rank=True)
        run.call("release")
        check_mesh_s = time.perf_counter() - t
    mesh_s = time.perf_counter() - t0
    summary = {"card": card, "transport": transport, "mesh": list(
        LM_LONG_SHAPE), "slots": slots, "prompt": prompt, "gen": gen,
        "mesh_s": mesh_s}
    for key, (cfg, cell, stats, secs) in cells.items():
        out = cell["tokens"]
        if tuple(out.shape) != (1, gen) or int(out.min()) < 0 or \
                int(out.max()) >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name}: tokens {tuple(out.shape)} "
                                 "out of range")
        fl = mesh_flops(cfg, 1, prompt, LM_LONG_SHAPE, cfg.capacity_factor)
        pos = prompt + gen // 2
        nbytes = ssm_decode_bytes(cfg, 1, pos)
        # the work this port does: each data rank runs the whole prompt
        # and reads every weight and SSM state, the batch replicated
        rep_bytes = ssm_decode_bytes(cfg, 1, pos, data)
        summary[key] = {
            "arch": cfg.name, "layers": cfg.num_layers,
            "mesh": list(LM_LONG_SHAPE), "transport": transport, "batch": 1,
            "prompt": prompt, "gen": gen, "slots": slots,
            "slots_per_data_rank": -(-slots // data),
            "params": cfg.param_count(), "param_bytes": param_bytes(cfg),
            "cell_s": secs, **mesh_cell_summary(cell, stats, 1, gen, card),
            "prefill_flops_needed": fl["need"],
            "prefill_bound_ms": fl["need"] / BF16_FLOPS * 1e3,
            "decode_bound_bytes": nbytes,
            "decode_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "prefill_replicated_bound_ms": fl["need"] * data / BF16_FLOPS
            * 1e3,
            "decode_replicated_bound_ms": rep_bytes / HBM_BYTES_PER_S
            * 1e3}
    ranks = f["rank_logits"]
    same = all(torch.equal(r, ranks[0]) for r in ranks[1:])
    if not same:
        raise AssertionError("the data ranks' logits differ")
    t = time.perf_counter()
    got = mesh_logical(torch, f["logits"], gemma32, LM_LONG_SHAPE)
    want = single_logits(torch, gemma32, seed, tokens_f, check_steps, device)
    rel = row_rel(got, want)
    if not rel <= LM_MESH_TOL:
        raise AssertionError(f"gemma3-4b float32 sequence-sharded logits "
                             f"differ from one device by {rel:.4g} of the "
                             "row's largest")
    summary["check_f"] = {
        "arch": gemma.name, "layers": layers, "slots": check_slots,
        "prompt": check_prompt, "steps": check_steps, "max_rel_err": rel,
        "max_rel_err_by_position": [row_rel(got[:, i], want[:, i])
                                    for i in range(got.shape[1])],
        "tolerance": LM_MESH_TOL, "ranks_bitwise_equal": same,
        "argmax_agree": float((got.argmax(-1) == want.argmax(-1)).float()
                              .mean()),
        "mesh_s": check_mesh_s, "single_s": time.perf_counter() - t}
    for key in ("gemma3_4b", "hymba"):
        log_serve_cell("lm_mesh_long", dict(summary[key]), card)
    log(f"[lm_mesh_long] {card}: check (f) gemma3-4b float32 {data} x {m}, "
        f"{check_slots} slots, prompt {check_prompt}: {rel:.4g} of the "
        f"row's largest logit against one device (tol {LM_MESH_TOL:.4g}); "
        f"every rank's logits the same bits: {same}")
    log(json.dumps({"lm_mesh_long": summary}))
    return summary


# -- the LM training path (lm100m, gemma3-4b at full width) ------------------

# lm100m's steps cut from 300 to 50 when the examples joined the script
# (its time; PERF.md section 4): the train_lm twin runs the same preset
# through the same launcher, and the loss falls by 9 within 50 steps
LM100M_STEPS, LM100M_BATCH, LM100M_SEQ = 50, 8, 256
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_MB = 6, 2, 2048, 2
# card against CPU, one train step of each smoke arch (float32, TF32 off),
# with the bounds tests/test_torch_lm_grads.py holds the port to the JAX
# package with: the loss within rtol 1e-5; the grad norm, each gradient leaf
# and each updated parameter within rtol 1e-4 and atol 1e-5 of the leaf's
# largest magnitude.  Step 1 moves every element by lr * sign(g) (AdamW's
# first step), so an element whose gradient is itself under that atol may
# move either way: such elements are counted, not failed.
LM_LOSS_RTOL, LM_GRAD_RTOL, LM_GRAD_ATOL = 1e-5, 1e-4, 1e-5
LM_MB_ARCH = "gemma3-4b"          # the card-vs-CPU case with microbatch 2
# _bmm_f32's backward on the card: a bf16 attention step against the same
# step with the operands of every product widened to float32 and autograd's
# own float32 backward.  The two forwards sum the same exact products in
# other orders, so a bf16 rounding (p, the output, each gradient) may land
# one ulp apart: at most 2^-7 of a value, two such of the leaf's largest
# gradient bound the difference.
BMM_BF16_TOL = 2.0 ** -6


def lm_train_flops(model, batch: int, seq: int) -> int:
    """FLOPs a training step must do: forward and backward (6 a weight and
    token) of every block's matmul weights and the head, and of attention
    over the (query, key) pairs the causal mask and window leave (QK^T and
    PV: 4 a pair and head dim forward, 12 in all).  Remat's second forward
    is not counted: it is work the bound need not do."""
    cfg = model.cfg
    blocks = [b for n in ("blocks", "dense_blocks", "cross_blocks")
              for b in getattr(model, n, [])]
    weights = sum(p.numel() for b in blocks for p in b.parameters()
                  if p.dim() >= 2) + cfg.d_model * model.layout.pad_rows
    flops = 6 * batch * seq * weights
    for w in cfg.windows():
        pairs = sum(min(q + 1, w) if w else q + 1 for q in range(seq))
        flops += 12 * batch * cfg.num_heads * cfg.head_dim_ * pairs
    return flops


def lm_train_bytes(model, microbatches: int) -> int:
    """Bytes AdamW and the gradient accumulation must move a step: per
    parameter, the update reads the gradient, both float32 moments and the
    weight and writes the moments and the weight; with microbatches the
    float32 accumulator is read and written and a microbatch's gradient
    (the weight's dtype) read, once a microbatch."""
    n = 0
    for p in model.parameters():
        w = p.element_size()
        grad = 4 if microbatches > 1 else w
        n += p.numel() * (grad + 16 + 2 * w)
        if microbatches > 1:
            n += p.numel() * microbatches * (8 + w)
    return n


def perturb_constants(torch, model, seed: int) -> None:
    """Noise on every constant leaf (zero norm scales and gates, unit
    mixes), so that each of them matters to the loss, as the CPU parity
    tests do to the JAX weights."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            flat = p.reshape(-1)
            if flat.numel() and bool((flat == flat[0]).all()):
                p.add_(0.3 * torch.randn(p.shape, generator=g).to(p))


def smoke_batch(cfg, seed: int, batch: int = 4, seq: int = 24) -> dict:
    from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
    return next(MarkovZipfSource(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=seed,
        cond_len=cfg.cond_len if cfg.cross_attn_mode else 0,
        cond_dim=cfg.cond_dim_ if cfg.cross_attn_mode else 0)).batches(1))


def batch_args(torch, batch: dict, device) -> list:
    keys = ["tokens", "targets", "mask"] + (["cond"] if "cond" in batch
                                            else [])
    return [torch.from_numpy(batch[k]).to(device) for k in keys]


def leaf_err(torch, got, want) -> float:
    """max |got - want| over the leaf's largest |want|."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale or 1.0)


def lm_train_card_vs_cpu(torch, seed: int, device: str, names=None) -> dict:
    """Each arch's smoke variant (float32) from the same weights (constant
    leaves perturbed) and the same batch on the card and on the CPU: the
    loss, its gradient (one backward) and one make_train_step (AdamW step
    1), within the LM_* bounds; LM_MB_ARCH once more with microbatch 2."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    out = {}
    cases = [(n, 0) for n in names or registry.all_arch_names()]
    for name, mb in cases + [(LM_MB_ARCH, 2)]:
        cfg = registry.smoke_variant(name)
        ref = tfm.init_params(seed, cfg, device="cpu")
        perturb_constants(torch, ref, seed)
        card = tfm.Transformer(cfg, device=device)
        card.load_state_dict(ref.state_dict())
        batch = smoke_batch(cfg, seed)
        tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, total_steps=10,
                         microbatch=mb)
        runs = []
        for model, dev in ((ref, "cpu"), (card, device)):
            args = batch_args(torch, batch, dev)
            loss, _ = tfm.loss_fn(model, *args)
            loss.backward()
            grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
            state = train_loop.TrainState(model, opt.init(
                dict(model.named_parameters())))
            state, met = train_loop.make_train_step(cfg, tc)(state, *args)
            runs.append((float(loss.detach()), grads,
                         {n: p.detach().cpu() for n, p in
                          model.named_parameters()},
                         {k: float(v) for k, v in met.items()}))
        (wl, wg, wp, wm), (gl, gg, gp, gm) = runs
        what = f"{name} (microbatch {mb})" if mb else name
        if not abs(gl - wl) <= LM_LOSS_RTOL * abs(wl):
            raise AssertionError(f"{what}: card loss {gl} against CPU {wl}")
        if not abs(gm["grad_norm"] - wm["grad_norm"]) <= \
                LM_GRAD_RTOL * wm["grad_norm"]:
            raise AssertionError(f"{what}: card grad norm {gm['grad_norm']} "
                                 f"against CPU {wm['grad_norm']}")
        grad_err = param_err = 0.0
        flips = 0
        for n in wg:
            g_tol = LM_GRAD_ATOL * float(wg[n].abs().max())
            err = leaf_err(torch, gg[n], wg[n])
            if not torch.allclose(gg[n], wg[n], rtol=LM_GRAD_RTOL,
                                  atol=g_tol):
                raise AssertionError(f"{what}: gradient of {n} differs from "
                                     f"the CPU's by {err:.3g} of its largest")
            grad_err = max(grad_err, err)
            close = torch.isclose(gp[n], wp[n], rtol=LM_GRAD_RTOL,
                                  atol=LM_GRAD_ATOL * float(wp[n].abs().max()))
            tiny = wg[n].abs() <= g_tol
            if bool((~close & ~tiny).any()):
                raise AssertionError(f"{what}: updated {n} differs from the "
                                     f"CPU's where its gradient is not tiny")
            flips += int((~close & tiny).sum())
            param_err = max(param_err, leaf_err(torch, gp[n], wp[n]))
        out[what] = {"loss_rel_err": abs(gl - wl) / abs(wl),
                     "grad_norm_rel_err": abs(gm["grad_norm"]
                                              - wm["grad_norm"])
                     / wm["grad_norm"],
                     "grad_max_rel_err": grad_err,
                     "param_max_rel_err": param_err,
                     "tiny_gradient_elements_moved_apart": flips}
    return out


def bmm_bf16_backward(torch, seed: int, device: str) -> dict:
    """One bf16 attention step of smoke gemma3-4b (qk-norm, a window,
    several q and kv tiles) on the card through ``_bmm_f32``'s backward,
    against the same step with every product's operands widened to
    float32 (autograd's own backward): the output and each gradient within
    BMM_BF16_TOL of the leaf's largest value."""
    import dataclasses as dc
    from repro_torch.configs import registry
    from repro_torch.models import attention
    cfg = dc.replace(registry.smoke_variant("gemma3-4b"), dtype="bfloat16")
    g = torch.Generator(device=device).manual_seed(seed)
    src = attention.Attention(cfg, device=device)
    src.reset_parameters(g)
    for norm in (src.q_norm, src.k_norm):
        with torch.no_grad():
            norm.scale.normal_(0.0, 0.3, generator=g)
    x0 = torch.randn((2, 80, cfg.d_model), generator=g, device=device
                     ).to(torch.bfloat16)
    w = torch.randn((2, 80, cfg.d_model), generator=g, device=device)
    positions = torch.arange(80, device=device)
    kernel = attention._bmm_f32
    runs = []
    for bmm in (kernel, lambda a, b: torch.bmm(a.float(), b.float())):
        attn = attention.Attention(cfg, device=device)
        attn.load_state_dict(src.state_dict())
        x = x0.clone().requires_grad_(True)
        attention._bmm_f32 = bmm
        try:
            out, _ = attn(x, positions=positions, window=8, theta=1e4)
            (out.float() * w).sum().backward()
        finally:
            attention._bmm_f32 = kernel
        leaves = {"out": out.detach(), "x": x.grad}
        leaves.update({n: p.grad for n, p in attn.named_parameters()})
        runs.append(leaves)
    got, want = runs
    errs = {}
    for n in want:
        if got[n].dtype != want[n].dtype:
            raise AssertionError(f"bmm backward: {n} is {got[n].dtype}, the "
                                 f"widened run's {want[n].dtype}")
        errs[n] = leaf_err(torch, got[n].float(), want[n].float())
        if not errs[n] <= BMM_BF16_TOL:
            raise AssertionError(f"bmm backward: {n} differs from the "
                                 f"widened operands' autograd by "
                                 f"{errs[n]:.4g} of its largest (tolerance "
                                 f"{BMM_BF16_TOL:.4g})")
    return {"max_rel_err": max(errs.values()), "tolerance": BMM_BF16_TOL,
            "bitwise_equal": sorted(n for n in want
                                    if torch.equal(got[n], want[n]))}


def param_sums(torch, model) -> dict:
    return {n: float(torch.sum(p.detach(), dtype=torch.float64))
            for n, p in model.named_parameters()}


def step_summary(torch, res, batch: int, seq: int, card: str,
                 device: str, profile_name: str) -> dict:
    """A cell's numbers from its run: the loss first -> last, step ms from
    the history's clock (each logged step synchronises), tokens/s; on the
    card one more step under the profiler (kernels, device busy, idle)."""
    from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
    from repro_torch.train import loop as train_loop
    hist = res.history
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"{res.cfg.name}: step {h['step']} loss "
                                 f"{h['loss']} grad norm {h['grad_norm']}")
    step_ms = [(b["elapsed_s"] - a["elapsed_s"]) * 1e3
               / (b["step"] - a["step"]) for a, b in zip(hist, hist[1:])]
    ms = float(np.median(step_ms))
    out = {"arch": res.cfg.name, "layers": res.cfg.num_layers,
           "d_model": res.cfg.d_model, "vocab": res.cfg.vocab_size,
           "dtype": res.cfg.dtype, "remat": res.cfg.remat, "batch": batch,
           "seq": seq, "microbatch": max(res.tc.microbatch, 1),
           "steps": res.tc.total_steps,
           "params": sum(p.numel() for p in res.state.model.parameters()),
           "loss_first": hist[0]["loss"], "loss_last": hist[-1]["loss"],
           "step_ms_median": ms, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms), "tokens_per_s": batch * seq / ms
           * 1e3, "card": card}
    if device != "cuda":
        out.update(dict.fromkeys(("step_kernels", "step_device_idle_share"),
                                 "not measured"))
        return out
    src = MarkovZipfSource(LMDataConfig(vocab_size=res.cfg.vocab_size,
                                        seq_len=seq, batch_size=batch,
                                        seed=1))
    args = batch_args(torch, src.batch(), device)
    step = train_loop.make_train_step(res.cfg, res.tc)
    state = res.state
    wall, busy, stats = device_profile(torch, lambda: step(state, *args))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / profile_name).write_text(
        f"{card}\none train step of {res.cfg.name} at batch {batch}, seq "
        f"{seq}, microbatch {out['microbatch']}: wall {wall:.3f} ms "
        f"(profiler on), device busy {busy:.3f} ms\n\n"
        f"{profile_table(stats)}\n")
    out.update({"step_profiled_wall_ms": wall, "step_device_busy_ms": busy,
                "step_device_idle_share": 1.0 - busy / wall,
                "step_kernels": sum(n for n, _ in stats.values()),
                "step_gemm_ms": sum(ms_ for k, (_, ms_) in stats.items()
                                    if any(t in k.lower() for t in
                                           ("gemm", "nvjet", "cutlass")))})
    return out


def train_step_split(torch, res, args: list) -> dict:
    """Where an eager step's device time goes, each part synchronised and
    timed alone on the trained state: one microbatch's forward and backward
    (its gradients left in ``.grad``, the weights' dtype), folding them
    into a float32 accumulator (what the step's hooks do), and AdamW on
    that accumulator (``optimizer.apply``, the global norm included)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt
    state, tc = res.state, res.tc
    mb = max(tc.microbatch, 1)
    n = args[0].shape[0] // mb
    part = [a[:n] for a in args]
    params = state.params

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    def fwd_bwd():
        loss, _ = tfm.loss_fn(state.model, *part)
        loss.backward()

    for p in params.values():
        p.grad = None
    fb_ms = timed(fwd_bwd)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}

    def fold():
        for k, p in params.items():
            train_loop._fold_into(acc[k], mb)(p)

    fold_ms = timed(fold)
    opt_ms = timed(lambda: opt.apply(acc, state.opt, params, tc))
    del acc
    return {"microbatch_forward_backward_ms": fb_ms,
            "microbatch_fold_ms": fold_ms, "adamw_ms": opt_ms,
            "split_step_ms": mb * (fb_ms + fold_ms) + opt_ms}


def remat_flops(model, batch: int, seq: int) -> int:
    """The second forward remat runs in the backward: every layer's matmul
    weights (2 a weight and token) and its attention pairs (4 a pair and
    head dim); the head is not rematerialised."""
    cfg = model.cfg
    blocks = [b for n in ("blocks", "dense_blocks", "cross_blocks")
              for b in getattr(model, n, [])]
    flops = 2 * batch * seq * sum(p.numel() for b in blocks
                                  for p in b.parameters() if p.dim() >= 2)
    for w in cfg.windows():
        pairs = sum(min(q + 1, w) if w else q + 1 for q in range(seq))
        flops += 4 * batch * cfg.num_heads * cfg.head_dim_ * pairs
    return flops


def add_bounds(cell: dict, model, batch: int, seq: int, mb: int) -> None:
    flops = lm_train_flops(model, batch, seq)
    nbytes = lm_train_bytes(model, mb)
    rate = FP32_FLOPS if model.cfg.dtype == "float32" else BF16_FLOPS
    cell.update({"flops": flops, "flop_bound_ms": flops / rate * 1e3,
                 "rate_flops_per_s": rate, "optimizer_bytes": nbytes,
                 "byte_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
    cell["bound_ms"] = cell["flop_bound_ms"] + cell["byte_bound_ms"]
    cell["bound_share"] = cell["bound_ms"] / cell["step_ms_median"]


def lm_train(torch, seed: int, card: str, device: str = "cuda",
             smoke: bool = False, lm100m_steps: int = LM100M_STEPS,
             seq: int = LM_TRAIN_SEQ) -> dict:
    """The LM training path through ``repro_torch.launch.train``'s main:
    lm100m (the JAX launcher's end-to-end preset) for ``lm100m_steps``
    steps, its loss falling by more than 0.5, its final npz written in the
    JAX package's layout; gemma3-4b at full width and depth for
    LM_TRAIN_STEPS steps of batch 2 x 2,048 with microbatch 2: finite
    losses and grad norms, every parameter and moment changed; step ms
    against the FLOP and byte bounds, tokens/s, peak memory, one step under
    the profiler and the step's split.  Then the smoke archs' train step
    card = CPU and _bmm_f32's bf16 backward.  ``smoke`` (a CPU rehearsal)
    trains gemma3-4b's smoke variant instead, at ``seq``."""
    import tempfile
    from repro_torch.configs import registry
    from repro_torch.launch import train as train_launch
    from repro_torch.models import transformer as tfm
    cuda = device == "cuda"
    summary = {"card": card}
    if cuda:
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    # lm100m until its loss falls
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = train_launch.main([
            "--preset", "lm100m", "--steps", str(lm100m_steps), "--batch",
            str(LM100M_BATCH), "--seq", str(LM100M_SEQ), "--seed", str(seed),
            "--device", device, "--out", tmp])
        run_s = time.perf_counter() - t0
        npz = Path(tmp) / "lm100m_final.npz"
        with np.load(npz) as data:
            if not np.array_equal(data["embed/table"],
                                  res.state.model.embed.table.detach().cpu()
                                  .numpy()):
                raise AssertionError("lm100m: the final npz's embedding "
                                     "differs from the model's")
        npz_bytes = npz.stat().st_size
    cell = step_summary(torch, res, LM100M_BATCH, LM100M_SEQ, card, device,
                        "lm100m_train_profile.txt")
    cell.update(npz_bytes=npz_bytes, run_s=run_s)
    if not cell["loss_last"] < cell["loss_first"] - 0.5:
        raise AssertionError(f"lm100m: the loss did not fall by 0.5: "
                             f"{cell['loss_first']} -> {cell['loss_last']}")
    add_bounds(cell, res.state.model, LM100M_BATCH, LM100M_SEQ, 1)
    if cuda:
        cell["phase_peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                     - base_mem) / 1e9
    summary["lm100m"] = cell
    log(f"[lm_train] lm100m: loss {cell['loss_first']:.4f} -> "
        f"{cell['loss_last']:.4f} in {lm100m_steps} steps; step "
        f"{cell['step_ms_median']:.2f} ms (bound {cell['bound_ms']:.3f}), "
        f"{cell['tokens_per_s']:.0f} tokens/s, {cell['step_kernels']} "
        f"kernels, idle {cell['step_device_idle_share']}; {card}")
    del res
    if cuda:
        torch.cuda.empty_cache()

    # gemma3-4b at full width and depth: first the sums of the weights
    # main will draw from the same seed, to show every one of them moved
    arch = ["--arch", LM_ARCH] + (["--smoke"] if smoke else [])
    cfg = registry.smoke_variant(LM_ARCH) if smoke else registry.get(LM_ARCH)
    probe = tfm.init_params(seed, cfg, device=device)
    before = param_sums(torch, probe)
    del probe
    if cuda:
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_launch.main(arch + [
        "--steps", str(LM_TRAIN_STEPS), "--batch", str(LM_TRAIN_BATCH),
        "--seq", str(seq), "--microbatch", str(LM_TRAIN_MB), "--seed",
        str(seed), "--device", device, "--log-every", "1", "--out", ""])
    run_s = time.perf_counter() - t0
    cfg, state = res.cfg, res.state
    if not smoke and (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.dtype,
                      cfg.remat) != (34, 2560, 262_144, "bfloat16", True):
        raise AssertionError(f"not gemma3-4b's full config: {cfg}")
    if int(state.opt.step) != LM_TRAIN_STEPS:
        raise AssertionError(f"{cfg.name}: {int(state.opt.step)} AdamW steps")
    after = param_sums(torch, state.model)
    still = [n for n in before if after[n] == before[n]]
    if still:
        raise AssertionError(f"{cfg.name}: unchanged parameters {still[:5]}")
    for n in state.opt.m:
        if not (float(state.opt.m[n].abs().max()) > 0
                and float(state.opt.v[n].max()) > 0):
            raise AssertionError(f"{cfg.name}: the moments of {n} are zero")
    mem = {}
    if cuda:
        mem = {"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "phase_peak_mem_gb": (torch.cuda.max_memory_allocated()
                                     - base_mem) / 1e9,
               "resident_gb": (torch.cuda.memory_allocated() - base_mem)
               / 1e9, "before_phase_gb": base_mem / 1e9}
    cell = step_summary(torch, res, LM_TRAIN_BATCH, seq, card, device,
                        "lm_train_profile.txt")
    cell.update(mem, run_s=run_s)
    add_bounds(cell, state.model, LM_TRAIN_BATCH, seq, LM_TRAIN_MB)
    cell["remat_flops"] = remat_flops(state.model, LM_TRAIN_BATCH, seq)
    cell["remat_ms_at_peak"] = cell["remat_flops"] / BF16_FLOPS * 1e3
    if cuda:
        from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
        args = batch_args(torch, MarkovZipfSource(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq,
            batch_size=LM_TRAIN_BATCH, seed=2)).batch(), device)
        cell.update(train_step_split(torch, res, args))
    summary["gemma3_4b"] = cell
    log(f"[lm_train] {cfg.name}: {cfg.num_layers} layers, loss "
        f"{cell['loss_first']:.4f} -> {cell['loss_last']:.4f}; step "
        f"{cell['step_ms_median']:.1f} ms (bound {cell['bound_ms']:.2f}: "
        f"{cell['flop_bound_ms']:.2f} FLOPs + {cell['byte_bound_ms']:.2f} "
        f"bytes), {cell['tokens_per_s']:.0f} tokens/s, peak "
        f"{mem.get('peak_mem_gb', 'not measured')} GB; {card}")
    del res, state
    if cuda:
        torch.cuda.empty_cache()

    summary["card_vs_cpu"] = lm_train_card_vs_cpu(torch, seed, device)
    if cuda:
        summary["bmm_bf16_backward"] = bmm_bf16_backward(torch, seed, device)
    log(json.dumps({"lm_train": summary}))
    return summary


# EM at large K from the Dirichlet(1) init stays near its symmetric fixed
# point (every γ row uniform), the JAX package's EM and the port's alike
# (tests/test_torch_baselines.py, K = 400 on 10k tokens).  From that K on,
# a perplexity that does not fall is accepted only for a run at that point:
# its float32 training perplexity within SYMMETRIC_RTOL of the fixed
# point's (computed in float64 on the host), nearer it than the start;
# every γ within SYMMETRIC_SPREAD / K of 1/K after the last iteration and
# nearer than after the first; and no γ row uniform after the first
# (a spread of at least EM_MOVED / K: the E-step read the counts).  The
# readings behind the limits stand in PERF.md (two seeds at K = 1,000 on
# the training corpus, H100 80GB HBM3) and in the CPU runs of the tests.
SYMMETRIC_MIN_K = 400
SYMMETRIC_RTOL = 2e-5
SYMMETRIC_SPREAD = 1.0
EM_MOVED = 0.5
REPLAY_PHASES = ("pull.inflight", "alias.build", "sample", "merge.store")


def baseline_corpus():
    """tests/test_lda_baselines.py's corpus: 200 docs, V = 300, 8 topics."""
    from repro_torch.data.corpus import generate_lda_corpus

    return generate_lda_corpus(seed=0, num_docs=200, mean_doc_len=50,
                               vocab_size=300, num_topics=8)


def corpus_tensors(torch, corp, device: str):
    """(w, d, valid) of every token of ``corp`` on ``device``."""
    return (torch.from_numpy(corp.w).to(device),
            torch.from_numpy(corp.d).to(device),
            torch.ones(corp.num_tokens, dtype=torch.bool, device=device))


def em_bytes(n: int, d: int, v: int, k: int) -> int:
    """Bytes an EM iteration moves: γ read and written, the n_dk and n_wk
    rows each token gathers, the two segment sums' [D, K] and [V, K]
    tables written, and the two token index streams."""
    return 4 * n * k * 4 + (d + v) * k * 4 + 2 * n * 4


def online_flops(b: int, k: int, v: int, e_iters: int) -> int:
    """Floating-point operations of one online-VB minibatch: per E-step
    iteration two [B, K] x [K, V] products (the normaliser and the
    back-projection), and the same two once more for the sufficient
    statistics."""
    return (e_iters + 1) * 2 * 2 * b * k * v


def fold_in_perplexity(torch, tokens, phi, num_docs: int,
                       alpha: float) -> float:
    """The fold-in perplexity of ``phi`` on the corpus (bench_table1's
    measure of online VB's topics)."""
    from repro_torch.core import perplexity as ppl

    w, d, valid = tokens
    theta = ppl.fold_in_theta(w, d, valid, phi, num_docs, alpha)
    ll = ppl.log_likelihood(w, d, valid, theta, phi)
    return float(torch.exp(-ll / int(valid.sum())))


class PeakMemory:
    """Peak device memory over a block: the process's peak, and its
    excess over what was allocated when the block began (the block's
    own)."""

    def __init__(self, torch, device: str):
        self.torch, self.on = torch, device == "cuda"

    def __enter__(self):
        if self.on:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()
            self.start = self.torch.cuda.memory_allocated()
        return self

    def __exit__(self, *exc):
        if self.on:
            self.torch.cuda.synchronize()
            self.peak = self.torch.cuda.max_memory_allocated()
            self.own = self.peak - self.start

    def fields(self) -> dict:
        if not self.on:
            return {"peak_device_bytes": None, "own_device_bytes": None}
        return {"peak_device_bytes": self.peak, "own_device_bytes": self.own}


def table1_row(algo: str, k: int, tokens_done: int, ppl_before: float,
               ppl_after: float, step_s: list, shuffle: int, bound_ms,
               bound_by: str, mem: PeakMemory, card: str, **extra) -> dict:
    runtime = sum(step_s)
    row = {"algo": algo, "K": k, "perplexity_before": ppl_before,
           "perplexity_after": ppl_after, "runtime_s": runtime,
           "step_ms": [t * 1e3 for t in step_s],
           "tokens_per_s": tokens_done / runtime,
           "shuffle_bytes_per_step": shuffle, "bound_ms_per_step": bound_ms,
           "bound_by": bound_by, **mem.fields(), **extra, "card": card}
    log(json.dumps({"table1": row}))
    if not (ppl_after < ppl_before or extra.get("at_symmetric_fixed_point")):
        raise AssertionError(f"{algo} at K={k}: perplexity did not fall: "
                             f"{ppl_before} -> {ppl_after}")
    return row


def symmetric_perplexity(corp, k: int, v: int, beta: float) -> float:
    """The training perplexity of EM's symmetric fixed point, where every
    γ row is uniform: θ_d is uniform and every topic's φ_w is
    (c_w/K + β)/(N/K + Vβ), so p(w) = (c_w + Kβ)/(N + KVβ), the smoothed
    unigram model.  In float64 on the host from the corpus alone."""
    count = np.bincount(corp.w, minlength=v).astype(np.float64)
    p = (count[corp.w] + k * beta) / (corp.num_tokens + k * v * beta)
    return float(np.exp(-np.log(p).mean()))


def timed(torch, device: str, fn):
    """``fn()`` and its seconds on the host clock, closed by a device
    synchronise."""
    t = time.perf_counter()
    out = fn()
    sync(torch, device)
    return out, time.perf_counter() - t


def gamma_spread(torch, gamma, valid, k: int) -> float:
    """K · max |γ_ik − 1/K| over the valid tokens, a token chunk at a time:
    0 exactly where every γ row is uniform, 1 where some γ is 0 or 2/K."""
    out, step = 0.0, max(1, (1 << 26) // k)
    for lo in range(0, gamma.shape[0], step):
        g = gamma[lo:lo + step][valid[lo:lo + step]]
        if g.numel():
            out = max(out, float((g - 1.0 / k).abs().max()) * k)
    return out


def em_run(torch, corp, tokens, cfg, seed: int, iters: int, device: str,
           spread: bool) -> dict:
    """EM from ``init_state(seed)``: its perplexity before and after, the
    seconds of each iteration, γ's spread (``gamma_spread``) after the
    init and each iteration when ``spread`` (off the clock), γ's largest
    row-sum error and n_k's mass error at the end."""
    from repro_torch.core import lda_em as em
    from repro_torch.core import perplexity as ppl

    def perplexity(st):
        return float(ppl.training_perplexity(*tokens, st.ndk, st.nwk, st.nk,
                                             cfg.alpha, cfg.beta))

    def measure(st):
        if spread:
            spreads.append(gamma_spread(torch, st.gamma, tokens[2], cfg.K))

    st = em.init_state(seed, *tokens, corp.num_docs, cfg)
    before, times, spreads = perplexity(st), [], []
    measure(st)
    for _ in range(iters):
        st, t = timed(torch, device, lambda: em.em_iteration(
            st, *tokens, corp.num_docs, cfg))
        times.append(t)
        measure(st)
    out = {"before": before, "after": perplexity(st), "times": times,
           "spread": spreads,
           "row_err": float((st.gamma.sum(-1).double() - 1.0).abs().max()),
           "nk_err": abs(float(st.nk.double().sum()) - corp.num_tokens)}
    del st
    return out


def at_symmetric_point(run: dict, sym: float) -> bool:
    """Whether an EM run (``em_run``) sits at the symmetric fixed point
    whose perplexity is ``sym``: the checks SYMMETRIC_* and EM_MOVED
    name."""
    gap = abs(run["after"] - sym)
    sp = run["spread"]
    return (gap <= SYMMETRIC_RTOL * sym and gap < abs(run["before"] - sym)
            and sp[1] >= EM_MOVED and sp[-1] <= SYMMETRIC_SPREAD
            and sp[-1] < sp[1])


def em_row(torch, corp, tokens, k: int, v: int, seed: int, iters: int,
           device: str, card: str) -> dict:
    """Spark-EM at (v, k): init, ``iters`` iterations, perplexity before
    and after; γ rows sum to 1 within 1e-4 and n_k to the tokens within
    1.0.  The perplexity must fall, or else, at K >= SYMMETRIC_MIN_K
    alone, the run must sit at EM's symmetric fixed point
    (``at_symmetric_point``), and so must a second run from seed + 1,
    whose perplexities and spreads the row records beside the first's."""
    from repro_torch.core import lda_em as em

    cfg = em.EMConfig(num_topics=k, vocab_size=v)
    n = corp.num_tokens
    large = k >= SYMMETRIC_MIN_K
    with PeakMemory(torch, device) as mem:
        run = em_run(torch, corp, tokens, cfg, seed, iters, device, large)
    if run["row_err"] > 1e-4 or run["nk_err"] > 1.0:
        raise AssertionError(f"EM at K={k}: γ rows off 1 by "
                             f"{run['row_err']}, n_k off the tokens by "
                             f"{run['nk_err']}")
    if device == "cuda" and k == K_FULL and mem.own > EM_PEAK_BYTES:
        raise AssertionError(f"EM at K={k} held {mem.own} bytes of device "
                             f"memory")
    bound = em_bytes(n, corp.num_docs, v, k) / HBM_BYTES_PER_S * 1e3
    extra = {"gamma_row_sum_err": run["row_err"], "nk_sum_err": run["nk_err"]}
    if large:
        sym = symmetric_perplexity(corp, k, v, cfg.beta)
        second = em_run(torch, corp, tokens, cfg, seed + 1, iters, device,
                        True)
        extra.update(
            symmetric_perplexity=sym, gamma_spread=run["spread"],
            second_seed={key: second[key]
                         for key in ("before", "after", "spread")},
            at_symmetric_fixed_point=(at_symmetric_point(run, sym)
                                      and at_symmetric_point(second, sym)))
    return table1_row("spark-em", k, n * iters, run["before"], run["after"],
                      run["times"], em.shuffle_bytes_per_iter(n, cfg), bound,
                      "bytes", mem, card, **extra)


def online_row(torch, corp, tokens, k: int, v: int, seed: int, batches: int,
               batch_docs: int, device: str, card: str) -> dict:
    """Spark-Online at (v, k): ``batches`` minibatches of ``batch_docs``
    documents, densified off the clock (bench_table1's pipeline), fold-in
    perplexity before and after.  One step on the first minibatch, its
    result dropped, runs before the clock starts: the first product at a
    shape sets up the BLAS library (~0.9 s at K = 80), as bench_table1
    compiles outside its timer."""
    from repro_torch.core import lda_online as ov
    from repro_torch.data.corpus import doc_term_matrix

    cfg = ov.OnlineConfig(num_topics=k, vocab_size=v, batch_docs=batch_docs)
    rng = np.random.default_rng(seed)
    picks = [rng.choice(corp.num_docs, batch_docs, replace=False)
             for _ in range(batches)]
    dense = [torch.from_numpy(doc_term_matrix(corp, p)).to(device)
             for p in picks]
    mask = torch.ones(batch_docs, device=device)
    done = int(sum(corp.doc_len[p].sum() for p in picks))
    with PeakMemory(torch, device) as mem:
        st = ov.init_state(seed, cfg, device=device)
        before = fold_in_perplexity(torch, tokens, ov.phi_from_state(st),
                                    corp.num_docs, cfg.alpha)
        timed(torch, device, lambda: ov.online_step(st, dense[0], mask,
                                                    corp.num_docs, cfg))
        times = []
        for dw in dense:
            st, t = timed(torch, device, lambda: ov.online_step(
                st, dw, mask, corp.num_docs, cfg))
            times.append(t)
        after = fold_in_perplexity(torch, tokens, ov.phi_from_state(st),
                                   corp.num_docs, cfg.alpha)
        del st
    del dense
    flops = online_flops(batch_docs, k, v, cfg.e_iters)
    return table1_row("spark-online", k, done, before, after, times,
                      k * v * 4, flops / FP32_FLOPS * 1e3, "operations",
                      mem, card, batch_docs=batch_docs,
                      flops_per_step=flops)


def lightlda_row(torch, corp, k: int, v: int, seed: int, train,
                 device: str, card: str) -> dict:
    """LightLDA-PS at (v, k) through APSLDA, the training cell's job: 3
    snapshot sweeps, their spans' ms; the training phase's run where it is
    at this K.  The perplexity before is the session's initial state's."""
    from repro_torch.api import APSLDA, Session
    from repro_torch.core import perplexity as ppl

    reuse = train is not None and train["cfg"].K == k
    obs_dir = ROOT / "chiprun_out" / "baselines_obs" / f"lightlda_k{k}"
    job = train["job"] if reuse else lightlda_job(corp, v, k, seed, obs_dir)
    with PeakMemory(torch, device) as mem:
        st0, _, _ = Session(job, log_fn=lambda m: None,
                            device=device).make_step()
        cfg = job.lda_config(v)
        before = float(ppl.training_perplexity(
            st0.w, st0.d, st0.valid, st0.ndk, st0.nwk.to_dense(),
            st0.nk.value, cfg.alpha, cfg.beta))
        del st0
        if reuse:
            sweep_ms, history = train["sweep_ms"], train["perplexity"]
        else:
            model = APSLDA(job, log_fn=lambda m: None, device=device).fit()
            sync(torch, device)
            sweep_ms = [a for a, _ in sweep_spans(obs_dir / "trace.json")]
            history = [row["perplexity"] for row in model.history]
            del model
    return table1_row("lightlda-ps", k, corp.num_tokens * len(sweep_ms),
                      before, history[-1], [t / 1e3 for t in sweep_ms],
                      v * k * 4, None, "not bounded", mem, card,
                      reused_training_run=reuse)


def max_rel_err(torch, got, want) -> float:
    """max |got - want| / |want| over the elements (|want| floored at the
    smallest normal float32, so an exact zero must be met exactly)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs()
                  / want.abs().clamp_min(1.1754943508222875e-38)).max())


def baselines_card_vs_cpu(torch, seed: int, device: str = "cuda") -> dict:
    """At tests/test_lda_baselines.py's size (K = 10): EM from a state
    drawn on the CPU, and online VB from a λ drawn on the CPU (32-document
    minibatches of np.random.default_rng(0), as that file draws them), run
    on ``device`` and on the CPU, held within BASELINE_CASES' tolerances;
    and EM's perplexity after 40 iterations within QUALITY_GAP of
    LightLDA's on ``device``."""
    from repro_torch import rng as jrng
    from repro_torch.core import lda_em as em
    from repro_torch.core import lda_online as ov
    from repro_torch.core import lightlda as lda
    from repro_torch.core import perplexity as ppl
    from repro_torch.data.corpus import doc_term_matrix

    corp = baseline_corpus()
    cpu = corpus_tensors(torch, corp, "cpu")
    dev = corpus_tensors(torch, corp, device)
    ecfg = em.EMConfig(num_topics=10, vocab_size=300)
    ocfg = ov.OnlineConfig(num_topics=10, vocab_size=300, batch_docs=32)
    em0 = em.init_state(seed, *cpu, corp.num_docs, ecfg)
    ov0 = ov.init_state(seed, ocfg, device="cpu")
    rng = np.random.default_rng(0)
    dense = [torch.from_numpy(doc_term_matrix(corp, rng.choice(
        corp.num_docs, 32, replace=False))) for _ in range(30)]
    mask = torch.ones(32)
    errs = {}
    for algo, steps, rtol in BASELINE_CASES:
        runs = {}
        for where, toks in (("cpu", cpu), (device, dev)):
            if algo == "em":
                st = em.train(em.EMState(*(x.to(where, copy=True)
                                           for x in em0)),
                              *toks, corp.num_docs, ecfg, steps)
            else:
                st = ov.train(ov.OnlineState(*(x.to(where) for x in ov0)),
                              [x.to(where) for x in dense[:steps]],
                              [mask.to(where)] * steps, corp.num_docs, ocfg)
            runs[where] = st
        err = max(max_rel_err(torch, a, b)
                  for a, b in zip(runs[device], runs["cpu"])
                  if a.dtype.is_floating_point)
        errs[f"{algo}_{steps}"] = err
        if err > rtol:
            raise AssertionError(f"{algo} after {steps} steps on {device} "
                                 f"differs from the CPU by {err} > {rtol}")

    lcfg = lda.LDAConfig(num_topics=10, vocab_size=300, block_tokens=2048)
    ls = lda.init_state(jrng.PRNGKey(0, device), dev[0], dev[1],
                        corp.num_docs, lcfg)
    ls = lda.train(ls, jrng.PRNGKey(1, device), lcfg, 40)
    p_light = float(ppl.training_perplexity(
        ls.w, ls.d, ls.valid, ls.ndk, ls.nwk.to_dense(), ls.nk.value,
        lcfg.alpha, lcfg.beta))
    es = em.train(em.init_state(seed, *dev, corp.num_docs, ecfg), *dev,
                  corp.num_docs, ecfg, 40)
    p_em = float(ppl.training_perplexity(*dev, es.ndk, es.nwk, es.nk,
                                         ecfg.alpha, ecfg.beta))
    gap = abs(p_light - p_em) / min(p_light, p_em)
    out = {"tokens": corp.num_tokens, "K": 10, "max_rel_err": errs,
           "tolerance": {f"{a}_{s}": r for a, s, r in BASELINE_CASES},
           "perplexity_lightlda": p_light, "perplexity_em": p_em,
           "gap": gap}
    log(json.dumps({"check": "baselines_card_vs_cpu", **out}))
    if gap >= QUALITY_GAP:
        raise AssertionError(f"EM and LightLDA perplexities {p_em} and "
                             f"{p_light} differ by {gap:.3f}")
    return out


def baselines(torch, seed: int, card: str, corp, train=None,
              device: str = "cuda", v: int = V_FULL, ks=TABLE1_KS,
              em_iters: int = EM_ITERS, batches: int = ONLINE_BATCHES,
              batch_docs: int = ONLINE_BATCH_DOCS) -> list:
    """Paper Table 1 on ``device``: Spark-EM, Spark-Online and LightLDA-PS
    on the training corpus at V = ``v`` for each K in ``ks`` (perplexity
    before and after, runtime, tokens/s, the shuffle model, peak device
    memory; each perplexity must fall), then ``baselines_card_vs_cpu``.
    ``train`` is the training phase's result, whose run stands for
    LightLDA-PS at its K."""
    tokens = corpus_tensors(torch, corp, device)
    rows = []
    for k in ks:
        rows.append(em_row(torch, corp, tokens, k, v, seed, em_iters, device,
                           card))
        rows.append(online_row(torch, corp, tokens, k, v, seed, batches,
                               batch_docs, device, card))
        rows.append(lightlda_row(torch, corp, k, v, seed, train, device,
                                 card))
    log(f"[table1] {'algo':<13} {'K':>5} {'ppl before':>11} "
        f"{'ppl after':>10} {'runtime s':>10} {'tokens/s':>12} "
        f"{'shuffle MB':>11}")
    for r in rows:
        log(f"[table1] {r['algo']:<13} {r['K']:>5} "
            f"{r['perplexity_before']:>11.1f} {r['perplexity_after']:>10.1f} "
            f"{r['runtime_s']:>10.3f} {r['tokens_per_s']:>12.0f} "
            f"{r['shuffle_bytes_per_step'] / 1e6:>11.1f}")
    baselines_card_vs_cpu(torch, seed, device)
    return rows


def replay_groups_filled(state, group_rows: int) -> int:
    """The replay's groups that hold a valid token (of the state's words
    in their physical rows)."""
    w = state.nwk.layout.to_physical(state.w[state.valid])
    return nonempty_blocks(w.cpu().numpy(), group_rows)


def replay_launches(route, group_rows: int, groups: int,
                    filled: int) -> dict:
    """The replay's launches: per group one mh_draws_train, alias_build and
    mh_sample, and per group that holds a token (``filled``) what the
    route's group-local delta issues -- delta_push for a dense part,
    delta_apply_coo for a coordinate part (a group with no token merges
    nothing and launches neither)."""
    from repro_torch import ps

    dense = coo = 1
    if isinstance(route, ps.DenseRoute):
        coo = 0
    elif isinstance(route, ps.CooRoute):
        dense = 0
    else:
        hot = route.clamped(group_rows)
        dense, coo = int(hot > 0), int(hot < group_rows)
    return {"mh_sample": groups, "alias_build": groups,
            "mh_draws_train": groups, "mh_draws_foldin": 0,
            "delta_push": dense * filled, "delta_apply_coo": coo * filled}


def replay(torch, seed: int, card: str, train: dict,
           device: str = "cuda") -> dict:
    """``obs.exec_trace.traced_pipelined_sweep`` on the trained state with
    the pipelined cell's geometry (16 model blocks, staleness 1) and
    HybridRoute(2000), under an obs session writing to
    chiprun_out/replay_obs/: bitwise equal to the pipelined executor on the
    same state and key (z, n_wk, n_k, n_dk); its launches per group; the
    median ms of each phase span; the trace rendered by
    ``launch.obs_report``, which must name all four phases."""
    from repro_torch import obs
    from repro_torch import rng as jrng
    from repro_torch.api import HybridRoute, ObsConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import obs_report
    from repro_torch.obs import exec_trace
    from repro_torch.train import async_exec

    st, cfg = train["state"], train["cfg"]
    route = HybridRoute(hot_words=HOT_WORDS)
    key = jrng.PRNGKey(seed + 19, device)
    out_dir = ROOT / "chiprun_out" / "replay_obs"
    shutil.rmtree(out_dir, ignore_errors=True)

    ops.reset_launch_counts()
    # ------------------------------------------------------------ main path
    with obs.session(ObsConfig(enabled=True, out_dir=str(out_dir))):
        t0 = time.perf_counter()
        got = exec_trace.traced_pipelined_sweep(
            st, key, cfg, model_blocks=PIPE_BLOCKS,
            staleness=PIPE_STALENESS, route=route)
        sync(torch, device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    # ---------------------------------------------------- end of main path
    step, info = async_exec.make_executor(
        st, cfg, async_exec.ExecConfig(staleness=PIPE_STALENESS,
                                       model_blocks=PIPE_BLOCKS,
                                       route=route))
    want = step.raw(st, key)
    equal = {"z": bool(torch.equal(got.z, want.z)),
             "nwk": bool(torch.equal(got.nwk.value, want.nwk.value)),
             "nk": bool(torch.equal(got.nk.value, want.nk.value)),
             "ndk": bool(torch.equal(got.ndk, want.ndk))}
    del want
    if not all(equal.values()):
        raise AssertionError(f"the replay differs from the pipelined "
                             f"executor: {equal}")
    conservation(torch, got, "replay")
    del got
    groups = groups_per_sweep(info)
    group_rows = info["rows_per_block"] * info["group"]
    filled = replay_groups_filled(st, group_rows)
    check_launches(counts, replay_launches(route, group_rows, groups,
                                           filled), "replay", device)
    events, metrics = read_obs(out_dir)
    phases = {name: span_ms(events, name) for name in REPLAY_PHASES}
    if (metrics["replay.groups"]["value"] != groups
            or any(len(phases[n]) != groups for n in REPLAY_PHASES[1:])
            or len(phases["pull.inflight"]) != groups + 1):
        raise AssertionError(f"the replay's trace holds "
                             f"{ {n: len(x) for n, x in phases.items()} } "
                             f"spans for {groups} groups")
    text = obs_report.render(str(out_dir))
    table = text.split("\n\n")[1]
    for line in table.splitlines():
        log(f"[replay] {line}")
    missing = [n for n in REPLAY_PHASES if n not in table]
    if missing:
        raise AssertionError(f"obs_report's span table lacks {missing}")
    log(json.dumps({"replay": {
        "V": cfg.V, "K": cfg.K, "groups": groups, "groups_filled": filled,
        "group_rows": group_rows,
        "token_cap": info["token_cap"], "route": repr(route),
        "wall_ms": wall_ms,
        "median_ms": {n: median(x) for n, x in phases.items()},
        "total_ms": {n: float(sum(x)) for n, x in phases.items()},
        "launches": counts, "equal_to_executor": equal, "card": card}}))
    return {"counts": counts, "group_rows": group_rows, "groups": groups}


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


# -- the six user examples' twins (examples/*_torch.py) ----------------------

EXAMPLES = ROOT / "examples"
# the kernels each in-process twin must launch on the card: the draws, B1,
# B2 and B3 (its in-process merge), the key derivations and the init draw;
# B4 is the SPMD wrapper's
EXAMPLE_KERNELS = ("mh_draws_train", "mh_sample", "alias_build",
                   "delta_push", "threefry_keys", "threefry_randint")
EXAMPLE_TIMEOUT = 600
THROUGHPUT = ("tok/s", "docs/s", "tokens/s")


class Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def example_module(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def throughput_lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines()
            if any(u in ln for u in THROUGHPUT)]


def in_process_twin(torch, name: str, device: str):
    """``examples/<name>_torch.py``'s ``main(device)`` in this process,
    between a reset and a read of the launch counters; returns what
    ``main`` returned, its stdout, its wall seconds and the launches."""
    from repro_torch.kernels import ops

    mod = example_module(name)
    tee = Tee(sys.stdout)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # --------------------------------------------------------------- main path
    with contextlib.redirect_stdout(tee):
        res = mod.main(device)
    sync(torch, device)
    # ------------------------------------------------------- end of main path
    return res, tee.text(), time.perf_counter() - t0, ops.launch_counts()


def run_wrappers(*wrappers: tuple) -> dict:
    """``python examples/<name>_torch.py ARGV`` for each ``(name, *argv)``
    of ``wrappers``, as a user runs it, all at once; each one's output,
    exit code and wall seconds (its start to its exit)."""
    done = {}

    def run(name, *argv):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(EXAMPLES / f"{name}_torch.py"), *argv],
            cwd=str(ROOT), stdin=subprocess.DEVNULL, capture_output=True,
            text=True, timeout=EXAMPLE_TIMEOUT)
        done[name] = (proc, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=w) for w in wrappers]
    for th in threads:
        th.start()
    for th in threads:
        th.join(EXAMPLE_TIMEOUT + 60)
    out = {}
    for name, *argv in wrappers:
        if name not in done:
            raise AssertionError(f"examples/{name}_torch.py did not finish")
        proc, s = done[name]
        for ln in proc.stdout.splitlines()[-40:]:
            log(f"[examples] {name}: {ln}")
        if proc.returncode != 0:
            raise AssertionError(
                f"examples/{name}_torch.py {' '.join(argv)} exited "
                f"{proc.returncode}: {proc.stderr[-4000:]}")
        out[name] = {"argv": argv, "s": s, "stdout": proc.stdout,
                     "throughput": throughput_lines(proc.stdout)}
    return out


def falling(values: list, what: str) -> None:
    if len(values) < 2 or not all(math.isfinite(x) for x in values) or \
            not values[-1] < values[0]:
        raise AssertionError(f"{what} does not fall: {values}")


def quickstart_cpu_reference(out_path: Path) -> subprocess.Popen:
    """The quickstart on the CPU in a process of its own, beside the card's
    run: its stdout, and n_wk and n_k in ``out_path``."""
    code = ("import sys, numpy as np\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            "import chip_smoke as c\n"
            "model, _, _ = c.example_module('quickstart').main('cpu')\n"
            f"np.savez({str(out_path)!r}, nwk=model.nwk, nk=model.nk)\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def result_lines(text: str) -> list:
    """The quickstart's printed results: the top words and best docs."""
    return [ln for ln in text.splitlines()
            if ln.startswith("  topic") or ln.startswith("  query")]


def examples(torch, card: str, device: str = "cuda") -> dict:
    """The six user examples' twins on the card, at the JAX examples' own
    sizes: quickstart and stream_train in this process (launch counters:
    mh_draws, B1, B2 and B3; quickstart's counts and printed results equal
    the same ``main`` on the CPU, run in a process of its own meanwhile),
    then the four wrappers as ``python examples/<name>_torch.py``
    subprocesses, all four at once (train_lm with ``--steps 50``): the
    snapshot published and queries scored, the SPMD ranks' perplexity
    falling with their B3 and B4 launches, (8, 48) tokens generated, a
    finite falling loss.  Each wrapper's seconds and throughput lines are
    therefore those of four programs sharing the card and the host."""
    import tempfile

    out = {}
    dev = [] if device == "cuda" else ["--device", device]
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = Path(tmp) / "quickstart_cpu.npz"
        ref = quickstart_cpu_reference(ref_path) if device == "cuda" \
            else None
        (model, theta, scores), q_text, s, launches = in_process_twin(
            torch, "quickstart", device)
        ppl = [r["perplexity"] for r in model.history]
        falling(ppl, "quickstart's perplexity")
        out["quickstart"] = {"s": s, "launches": launches,
                             "perplexity": ppl,
                             "theta_shape": list(theta.shape),
                             "scores_shape": list(scores.shape),
                             "throughput": throughput_lines(q_text)}
        st_model, text, s, launches = in_process_twin(torch, "stream_train",
                                                      device)
        if "conservation check OK" not in text:
            raise AssertionError("stream_train: no conservation line")
        out["stream_train"] = {"s": s, "launches": launches,
                               "perplexity": [r["perplexity"]
                                              for r in st_model.history],
                               "throughput": throughput_lines(text)}
        if device == "cuda":
            for name, fold_in in (("quickstart", ("mh_draws_foldin",)),
                                  ("stream_train", ())):
                c = out[name]["launches"]
                if not all(c[k] for k in EXAMPLE_KERNELS + fold_in):
                    raise AssertionError(f"{name}: kernels not launched: "
                                         f"{c}")
        t0 = time.perf_counter()
        out.update(run_wrappers(("serve_topics", *dev),
                                ("lda_distributed", *dev),
                                ("serve_lm", *dev),
                                ("train_lm", "--steps", "50", *dev)))
        wrappers_s = time.perf_counter() - t0
        if ref is not None:
            t0 = time.perf_counter()
            ref_out, ref_err = ref.communicate(timeout=EXAMPLE_TIMEOUT)
            wait_s = time.perf_counter() - t0
            if ref.returncode != 0:
                raise AssertionError(f"quickstart on the CPU failed: "
                                     f"{ref_err[-4000:]}")
            want = np.load(ref_path)
            equal = (np.array_equal(model.nwk, want["nwk"])
                     and np.array_equal(model.nk, want["nk"]))
            same_lines = result_lines(q_text) == result_lines(ref_out)
            if not (equal and same_lines):
                raise AssertionError(
                    f"quickstart on the card differs from the CPU: counts "
                    f"equal {equal}, printed results equal {same_lines}:\n"
                    f"{result_lines(q_text)}\n{result_lines(ref_out)}")
            out["quickstart"]["card_vs_cpu"] = {
                "counts_equal": equal, "results_equal": same_lines,
                "wait_after_wrappers_s": wait_s}
    r = out["serve_topics"]
    if not ("published snapshot v5" in r["stdout"]
            and r["stdout"].count("best docs") == 4):
        raise AssertionError("serve_topics: no snapshot or no scores")
    r = out["lda_distributed"]
    ppl = [float(x) for x in re.findall(r"perplexity\s+([\d.]+)",
                                        r["stdout"])]
    falling(ppl, "lda_distributed's perplexity")
    m = re.search(r"kernel launches over 8 ranks \((\w+)\): (.*)",
                  r["stdout"])
    if m is None:
        raise AssertionError("lda_distributed: no launch line")
    launches = {k: int(n) for k, n in (p.rsplit(" ", 1)
                                       for p in m.group(2).split(", "))}
    if device == "cuda" and not (launches["delta_push"]
                                 and launches["delta_apply_coo"]):
        raise AssertionError(f"lda_distributed: B3/B4 not launched: "
                             f"{launches}")
    r.update(perplexity=ppl, transport=m.group(1), launches=launches)
    if "generated (8, 48) tokens" not in out["serve_lm"]["stdout"]:
        raise AssertionError("serve_lm: not (8, 48) tokens")
    r = out["train_lm"]
    m = re.search(r"\[train\] loss (\S+) -> (\S+) ", r["stdout"])
    if m is None:
        raise AssertionError("train_lm: no loss line")
    loss = [float(m.group(1)), float(m.group(2))]
    falling(loss, "train_lm's loss")
    r.update(loss=loss, steps=[ln for ln in r["stdout"].splitlines()
                               if ln.startswith("step")])
    for v in out.values():
        v.pop("stdout", None)
    summary = {"card": card, "wrappers_s": wrappers_s, **out}
    log(f"[examples] {card}: " + ", ".join(
        f"{k} {v['s']:.1f} s" for k, v in out.items())
        + f"; the four wrappers at once {wrappers_s:.1f} s")
    log(json.dumps({"examples": summary}))
    return summary


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


def snapshot_group_inputs(torch, train: dict, tokens: int = 0):
    """mh_sample's inputs in the snapshot executor's first group (8192
    tokens; ``tokens``: the first that many) of a sweep of the trained
    state: the [V, K] snapshot and its alias tables, the [D, K] n_dk.
    Returns them and the group's ``valid``."""
    from repro_torch import rng as jrng
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lightlda as lda

    st, cfg = train["state"], train["cfg"]
    g = tokens or cfg.block_tokens
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
    from repro_torch.kernels import delta_push

    w, _, _, zo, zn, changed = groups["snapshot"]
    nwk_dense = train["state"].nwk.to_dense()
    hot, cold_m = delta_push.split_hot_cold(w, changed, HOT_WORDS)
    cr, cc, cv = delta_push.cold_coo(w, zo, zn, cold_m)
    k = nwk_dense.shape[1]
    rows = []

    # B3, single destination: the hybrid's hot block [HOT_WORDS, K]
    rows.append(push_row(torch, timer, "delta_push", w, zo, zn, hot,
                         HOT_WORDS, k, push_counts["delta_push"], card))

    # B4: the cold tail's COO buffer applied into the [V, K] table
    rows.append(coo_row(torch, timer, "delta_apply_coo", cr, cc, cv,
                        nwk_dense, push_counts["delta_apply_coo"], card))
    return rows


def push_row(torch, timer: Timer, name: str, rows_idx, zo, zn, mask,
             h: int, k: int, launches: int, card: str) -> dict:
    """delta_push's single-destination row: the ``mask``ed reassignments
    of rows ``rows_idx`` into a fresh [h, k] buffer, held bitwise against
    its plain version, timed accumulating into a buffer made outside the
    span, and against one index_put_ with accumulate (its flat indices and
    values made outside the span).  Bytes: the mask once per entry; of the
    index streams only the 32-byte sectors that hold an entry that adds;
    each touched 32-byte output sector read and written once."""
    from repro_torch.kernels import delta_push, ref

    got = delta_push.delta_push_cuda(rows_idx, zo, zn, mask, torch.zeros(
        (h, k), dtype=torch.int32, device="cuda"))
    want = ref.delta_push_ref(rows_idx, zo, zn, mask, h, k)
    err = int((got - want).abs().max())
    if err:
        raise AssertionError(f"{name}: delta_push differs from its plain "
                             f"version")
    del got, want
    buf = torch.zeros((h, k), dtype=torch.int32, device="cuda")
    ms = timer.ms(lambda: delta_push.delta_push_cuda(rows_idx, zo, zn, mask,
                                                     buf), reps=100)
    plain_ms = timer.ms(lambda: ref.delta_push_ref(rows_idx, zo, zn, mask, h,
                                                   k),
                        reps=20, device_only=False)
    m = mask
    flat = torch.cat([rows_idx[m].long() * k + zo[m].long(),
                      rows_idx[m].long() * k + zn[m].long()])
    vals = torch.cat([-torch.ones_like(zo[m]), torch.ones_like(zn[m])])
    lib = torch.zeros(h * k, dtype=torch.int32, device="cuda")
    lib_ms, lib_seen = time_library(torch, timer, lambda: lib.index_put_(
        (flat,), vals, accumulate=True))
    n_hot = int(m.sum())
    sectors = touched_sectors(torch, torch.cat([rows_idx[m], rows_idx[m]]),
                              torch.cat([zo[m], zn[m]]), k)
    t = rows_idx.shape[0]
    nbytes = t + (3 * stream_sectors(torch, m) + 2 * sectors) * SECTOR
    log(json.dumps({"timing": {name: {
        "rows": h, "K": k, "tokens": t, "hot_changed": n_hot,
        "sectors": sectors, "library": lib_seen, "card": card}}}))
    return kernel_row(
        name, "src/repro_torch/kernels/csrc/delta_push.cu",
        "src/repro/kernels/delta_push.py:39", launches, float(err), ms,
        plain_ms, nbytes, t * 2 + n_hot * 8, lib_ms)


def coo_row(torch, timer: Timer, name: str, cr, cc, cv, nwk_dense,
            launches: int, card: str) -> dict:
    """delta_apply_coo's row for the COO buffer (cr, cc, cv) applied into
    a copy of ``nwk_dense``: held bitwise against its plain version, timed
    against it and against one index_put_ with accumulate."""
    from repro_torch.kernels import delta_push, ref

    v, k = nwk_dense.shape
    got = delta_push.delta_apply_coo_cuda(cr, cc, cv, nwk_dense.clone())
    want = ref.delta_apply_coo_ref(cr, cc, cv, v, k, out=nwk_dense.clone())
    err = int((got - want).abs().max())
    if err:
        raise AssertionError(f"{name}: delta_apply_coo differs from its "
                             f"plain version")
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
    log(json.dumps({"timing": {name: {
        "rows": v, "K": k, "entries": cr.shape[0], "nonzero": n_nz,
        "sectors": sectors, "library": lib_seen, "card": card}}}))
    return kernel_row(
        name, "src/repro_torch/kernels/csrc/delta_push.cu",
        "src/repro/kernels/delta_push.py:133", launches, float(err), ms,
        plain_ms, nbytes, cr.shape[0] * 2 + n_nz * 6, lib_ms)


def spmd_kernel_rows(torch, timer: Timer, rows: list, train: dict,
                     spmd: dict, card: str, ranks: int = SPMD_RANKS) -> list:
    """The SPMD path's kernel rows, each with the launches of spmd_train
    summed over its ranks.  mh_draws_train, mh_sample, alias_build and
    delta_push's single-destination form run there at the shapes of rows
    already measured in this run (a rank's group is 8,192 tokens against
    the [100,000 x 1,000] snapshot and its sweep's alias tables, the
    hybrid's hot prefix is [2,000 x 1,000]): those rows' measurements are
    taken over (``timed_as``).  delta_apply_coo runs at a shape of its own,
    the cold COO buffers of ``ranks`` groups gathered (``ranks`` x 16,384
    entries into the [100,000 x 1,000] table), built from the trained
    state's first ``ranks`` snapshot groups: held bitwise and timed here."""
    from repro_torch.kernels import delta_push, mh_sample

    by_name = {r["name"]: r for r in rows}
    out = []
    for kernel, same in (("mh_draws_train", "mh_draws_train_snapshot"),
                         ("mh_sample", "mh_sample_train_snapshot"),
                         ("alias_build", "alias_build_train_snapshot"),
                         ("delta_push", "delta_push")):
        out.append(dict(by_name[same], name=f"{kernel}_spmd",
                        launches=spmd["launches"][kernel], timed_as=same))
    cfg = train["cfg"]
    g = cfg.block_tokens
    args, valid = snapshot_group_inputs(torch, train, tokens=ranks * g)
    z0, w = args[1], args[2]
    z_new = torch.where(valid, mh_sample.mh_sample_cuda(*args, cfg,
                                                        frozen=False), z0)
    changed = (z_new != z0) & valid
    parts = []
    for r in range(ranks):
        sl = slice(r * g, (r + 1) * g)
        _, cold = delta_push.split_hot_cold(w[sl], changed[sl], HOT_WORDS)
        parts.append(delta_push.cold_coo(w[sl], z0[sl], z_new[sl], cold))
    cr, cc, cv = (torch.cat([p[i] for p in parts]) for i in range(3))
    out.append(coo_row(torch, timer, "delta_apply_coo_spmd", cr, cc, cv,
                       train["state"].nwk.to_dense(),
                       spmd["launches"]["delta_apply_coo"], card))
    return out


def replay_kernel_rows(torch, timer: Timer, rows: list, train: dict,
                       groups: dict, replay_out: dict, card: str) -> list:
    """The replay's kernel rows, each with the replay's launches.  Its
    draws, chain and alias tables run at the pipelined executor's group
    shape (the same state and geometry): those rows' measurements are
    taken over (``timed_as``).  Its merge runs the route's group-local
    delta instead of the one-launch merge: delta_push's single-destination
    form for the hybrid's hot tokens into the [group rows, K] block and
    delta_apply_coo for the cold tail's COO into the group's pulled rows,
    held bitwise and timed here on the pipelined executor's first group's
    reassignments (``groups``), cut to the group's valid slots as the
    replay merges them (its tokens of words in the group's rows, which
    ``block_token_index`` puts first)."""
    from repro_torch.kernels import delta_push

    counts = replay_out["counts"]
    by_name = {r["name"]: r for r in rows}
    out = [dict(by_name[same], name=f"{kernel}_replay",
                launches=counts[kernel], timed_as=same)
           for kernel, same in (
               ("mh_draws_train", "mh_draws_train_pipelined"),
               ("mh_sample", "mh_sample_train_pipelined"),
               ("alias_build", "alias_build_train_pipelined"))]
    h, pulled = pipelined_group_rows(train)
    st = train["state"]
    n = int((st.nwk.layout.to_physical(st.w[st.valid]) < h).sum())
    local, words, _, zo, zn, changed = (x[:n] for x in groups["pipelined"])
    hot, cold = delta_push.split_hot_cold(words, changed, HOT_WORDS)
    out.append(push_row(torch, timer, "delta_push_replay", local, zo, zn,
                        hot, h, pulled.shape[1], counts["delta_push"], card))
    cr, cc, cv = delta_push.cold_coo(local, zo, zn, cold)
    out.append(coo_row(torch, timer, "delta_apply_coo_replay", cr, cc, cv,
                       pulled, counts["delta_apply_coo"], card))
    return out


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
    """One mh_draws row (an MHRandoms, or a tensor of threefry_keys or
    threefry_randint): the kernel held bitwise against its plain version
    on the same inputs, both timed, the bound from ``hashes`` threefry
    hashes at the int32 rate or ``nbytes``, whichever is larger."""
    got, want = kernel(), plain()
    draws = isinstance(got, tuple)
    if not (draws_match(torch, got, want) if draws
            else bool(torch.equal(got, want))):
        raise AssertionError(f"{name} differs from its plain version at the "
                             f"main path's shapes")
    shape = list((got.u_word if draws else got).shape)
    del got, want
    ms = timer.ms(kernel, reps=reps)
    plain_ms = timer.ms(plain, reps=plain_reps, device_only=False)
    log(json.dumps({"timing": {name: {
        "shape": shape, "hashes": hashes, "bytes": nbytes, "bitwise": True,
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
    return rows + threefry_rows(torch, timer, serve, train, keys, bucket,
                                card)


def threefry_rows(torch, timer: Timer, serve: dict, train: dict, keys,
                  bucket: int, card: str) -> list:
    """threefry_keys at a snapshot sweep's split(key, groups) and
    threefry_randint at serving's [32 x 1024] init draw (``keys``, fold_in
    0x1d4 folded in) and at training's init draw of the corpus' tokens
    from one key, each with its launches on its main path.  The work:
    a hash per fold-in datum per key, one per split key, two per drawn
    value plus split(key, 2)'s two a key; the bytes: the keys read, the
    keys or int32 values written."""
    from repro_torch import rng as jrng
    from repro_torch.kernels import mh_draws, ref

    st, cfg, fcfg = train["state"], train["cfg"], serve["model"].cfg
    key = jrng.PRNGKey(11, "cuda")
    groups = st.w.shape[0] // cfg.block_tokens
    b = keys.shape[0]
    n = int(train["corpus"].num_tokens)
    snap, served = train["snapshot_counts"], serve["counts"]
    return [
        draws_row(torch, timer, "threefry_keys",
                  lambda: mh_draws.threefry_keys_cuda(key, (), groups),
                  lambda: ref.threefry_keys_ref(key, (), groups),
                  snap["threefry_keys"], 16 + 16 * groups, groups, 100, 5,
                  card),
        draws_row(torch, timer, "threefry_randint_foldin",
                  lambda: mh_draws.threefry_randint_cuda(
                      keys, (bucket,), 0, fcfg.K, (0x1d4,)),
                  lambda: ref.threefry_randint_ref(keys, (bucket,), 0,
                                                   fcfg.K, (0x1d4,)),
                  served["threefry_randint"], 16 * b + 4 * b * bucket,
                  3 * b + 2 * b * bucket, 100, 5, card),
        draws_row(torch, timer, "threefry_randint_train_init",
                  lambda: mh_draws.threefry_randint_cuda(key, (n,), 0,
                                                         cfg.K),
                  lambda: ref.threefry_randint_ref(key, (n,), 0, cfg.K),
                  snap["threefry_randint"], 16 + 4 * n, 2 + 2 * n, 20, 2,
                  card)]


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
    """The launches of the key derivations and init draws, as the LDA paths
    issue them: ``ops.split(key, 244)`` a snapshot sweep,
    ``stream_sweep_key`` a stream or net visit, the fold-in init draw of a
    [32 x 1024] batch, and a stream shard's init draw of 262,144 tokens
    (``stream_init_key``, then ``ops.randint``).  For each: the tensor
    operations PyTorch dispatches (views not counted), the allocations
    among them (``empty``, which launch nothing), the hand-written
    kernels' launches (``ops`` counters), and ``launches``, the work the
    card is given: the dispatched operations less the allocations, plus
    the kernels' launches.  Each must be at most 2."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import rng as jrng
    from repro_torch.api.session import stream_init_key, stream_sweep_key
    from repro_torch.kernels import ops

    views = {"view", "_unsafe_view", "reshape", "expand", "select", "slice",
             "unsqueeze", "squeeze", "t", "transpose", "as_strided",
             "alias", "detach", "lift_fresh"}
    allocations = {"empty", "empty_strided", "empty_like"}

    class Count(TorchDispatchMode):
        n = allocs = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name not in views:
                self.n += 1
                self.allocs += name in allocations
            return func(*args, **(kwargs or {}))

    key = jrng.PRNGKey(3, "cuda")
    keys = jrng.keys_from_seeds(range(32), "cuda")
    out = {}
    for name, fn in (
            ("split_per_sweep", lambda: ops.split(key, 244)),
            ("stream_sweep_key_per_visit",
             lambda: stream_sweep_key(0, 1, 3, "cuda")),
            ("foldin_init_draw_per_batch",
             lambda: ops.randint(keys, (1024,), 0, K_FULL,
                                 fold_in=(0x1d4,))),
            ("stream_init_draw_per_shard",
             lambda: ops.randint(stream_init_key(0, 5, "cuda"),
                                 (STREAM_SHARD_TOKENS,), 0, K_FULL))):
        torch.cuda.synchronize()
        before = sum(ops.launch_counts().values())
        with Count() as c:
            fn()
        kernels = sum(ops.launch_counts().values()) - before
        out[name] = {"ops": c.n, "allocations": c.allocs,
                     "kernel_launches": kernels,
                     "launches": c.n - c.allocs + kernels}
    log(json.dumps({"eager_key_ops": dict(out, card=card)}))
    over = {k: v for k, v in out.items() if v["launches"] > 2}
    if over:
        raise AssertionError(f"key derivations over 2 launches: {over}")
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
    init = of_kernel(stats, "threefry_randint")
    if not busy_ms or not mh["count"] or not draws["count"]:
        raise AssertionError("the profile of a fold-in batch shows no device "
                             "time, or no mh_sample or mh_draws_foldin "
                             "launch")
    if init["count"] not in (1, 2):
        raise AssertionError(f"the fold-in batch's init draw took "
                             f"{init['count']} threefry_randint launches, "
                             f"not one or two")
    log(json.dumps({"profile": {
        "batch": [mb, bucket], "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernels": sum(n for n, _ in stats.values()),
        "launches_per_sweep": sum(n for n, _ in stats.values())
        / eng.ecfg.foldin.num_sweeps,
        "mh_sample_device_ms": mh["device_ms"],
        "mh_draws_foldin": draws, "threefry_randint": init,
        "card": card}}))


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
               "delta_push_kernel", "alias_build_kernel",
               "threefry_keys_kernel")
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
    ap.add_argument("--spmd-cpu", default="",
                    help=argparse.SUPPRESS)   # spmd_card_vs_cpu's CPU jobs
    ap.add_argument("--net-cpu", default="",
                    help=argparse.SUPPRESS)   # net_train's (d) on the CPU
    args = ap.parse_args(argv)

    import torch

    if args.spmd_cpu:
        spmd_cpu_runs(torch, args.seed, args.spmd_cpu)
        return 0
    if args.net_cpu:
        net_cpu_run(args.seed, args.net_cpu)
        return 0

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

    def phase(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        log(f"[phase] {name} {time.perf_counter() - t:.1f} s")
        return out

    phase("check_kernels", check_kernels, torch)
    phase("check_delta_kernels", check_delta_kernels, torch)
    phase("check_draws", check_draws, torch)
    phase("check_threefry", check_threefry, torch)
    # the mesh phases first: the float32 check holds 63 GB on the card
    phase("lm_mesh_serve", lm_mesh_serve, torch, args.seed, card)
    # one 2 x 2 mesh serves lm_mesh_dp's checks and lm_mesh_train, another
    # lm_mesh_ssm's (b) and lm_mesh_long
    pool = MeshPool(torch, "cuda")
    try:
        phase("lm_mesh_dp", lm_mesh_dp, torch, args.seed, card, pool=pool)
        phase("lm_mesh_train", lm_mesh_train, torch, args.seed, card,
              pool=pool)
        phase("lm_mesh_ssm", lm_mesh_ssm, torch, args.seed, card, pool=pool)
        phase("lm_mesh_long", lm_mesh_long, torch, args.seed, card,
              pool=pool)
    finally:
        pool.close()
    log(json.dumps({"mesh_pool": {"starts": pool.starts,
                                  "reuses": pool.reuses}}))
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
    spmd = phase("spmd_train", spmd_train, torch, args.seed, card,
                 train["corpus"])
    phase("spmd_stream", spmd_stream, torch, args.seed, card,
          train["corpus"])
    phase("spmd_nccl", spmd_nccl, torch, args.seed, card, train["corpus"])
    phase("spmd_card_vs_cpu", spmd_card_vs_cpu, torch, args.seed, card)
    phase("lm_serve", lm_serve, torch, args.seed, card)
    phase("lm_train", lm_train, torch, args.seed, card)
    timer = Timer(torch)
    rows, groups = phase("kernel_report", kernel_report, torch, timer, serve,
                         train, card)
    rows += phase("tiered_kernels", tiered_kernel_rows, torch, timer, tiered,
                  card)
    rows += phase("draws_kernels", mh_draws_rows, torch, timer, serve, train,
                  tiered, card)
    rows += phase("spmd_kernels", spmd_kernel_rows, torch, timer, rows,
                  train, spmd, card)
    phase("merge_compare", merge_compare, torch, timer, train, groups, card)
    phase("sweep_compare", sweep_compare, torch, train, card)
    phase("profile_batch", profile_batch, torch, serve, card)
    phase("eager_key_ops", eager_key_ops, torch, card)
    phase("profile_sweep", profile_sweep, torch, train, card)
    phase("baselines", baselines, torch, args.seed, card, train["corpus"],
          train)
    replayed = phase("replay", replay, torch, args.seed, card, train)
    rows += phase("replay_kernels", replay_kernel_rows, torch, timer, rows,
                  train, groups, replayed, card)
    phase("examples", examples, torch, card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
