#!/usr/bin/env python3
"""Drive the PyTorch port's topic-serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises and the script exits non-zero):

  1. device   -- require CUDA; print the card's name and power limit;
  2. build    -- nvcc every kernel of the path from src/repro_torch/kernels/
                 csrc, one process per source, all at once;
  3. kernels  -- each kernel against its plain PyTorch version on the card:
                 mh_sample bitwise at K in {7, 130, 1000} in both modes,
                 alias_build's pmf at rtol 3e-5 / atol 3e-6, rows with
                 exact-1.0 entries and near-one-hot rows included;
  4. serving  -- the slice at full width, V = 100,000 and K = 1,000, through
                 the entry points a user calls: TopicModel -> snapshot ->
                 transform of 512 documents -> score -> a ConcurrentEngine
                 under 8 client threads; launch counters, θ sums, batch
                 independence, and card θ == CPU-plain θ bitwise;
  5. report   -- one JSON line with each kernel's launches, error, times and
                 bound, then the device line last.

Imports nothing of JAX or of the JAX package.  Writes a profile of one
fold-in batch to chiprun_out/serving_profile.txt.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SECTOR = 32                    # bytes moved by one scattered 4-byte read

V_FULL, K_FULL = 100_000, 1_000
N_DOCS, N_QUERIES, N_CLIENTS, PER_CLIENT = 512, 8, 8, 16


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
                                   "within a sleep of 2^34 cycles")
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


def check_kernels(torch) -> None:
    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lightlda as lda
    from repro_torch.kernels import alias_build, mh_sample, ref

    for k in (7, 130, 1000):
        for frozen in (True, False):
            args = random_mh_inputs(torch, lda, rows=2048, k=k, t=32 * 1024,
                                    docs=32, seed=k)
            cfg = lda.LDAConfig(num_topics=k, vocab_size=2048)
            got = mh_sample.mh_sample_cuda(*args, cfg, frozen=frozen)
            want = ref.mh_sample_ref(*args, cfg, frozen=frozen)
            torch.cuda.synchronize()
            match = bool(torch.equal(got, want))
            moved = float((got != args[1]).float().mean())
            log(json.dumps({"check": "mh_sample", "K": k, "frozen": frozen,
                            "tokens": 32 * 1024, "match": match,
                            "moved_frac": round(moved, 4)}))
            if not match:
                raise AssertionError(f"mh_sample differs from its plain "
                                     f"version at K={k}, frozen={frozen}")

        wts = alias_test_weights(torch, rows=512, k=k, seed=k)
        got = alias_build.alias_build_cuda(wts)
        want = ref.alias_build_ref(wts)
        pmf_got = alias_mod.alias_pmf(got)
        pmf_want = alias_mod.alias_pmf(want)
        torch.cuda.synchronize()
        err = float((pmf_got - pmf_want).abs().max())
        close = bool(torch.allclose(pmf_got, pmf_want, rtol=3e-5, atol=3e-6))
        in_range = bool(((got.alias >= 0) & (got.alias < k)).all()
                        and ((got.prob >= 0) & (got.prob <= 1)).all())
        log(json.dumps({"check": "alias_build", "K": k, "rows": 512,
                        "pmf_max_abs_err": err, "match": close,
                        "ranges_ok": in_range}))
        if not (close and in_range):
            raise AssertionError(f"alias_build disagrees with its plain "
                                 f"version at K={k} (err {err})")


# -- phase 4: the serving slice ----------------------------------------------

def serve_slice(torch, seed: int, card: str, device: str = "cuda",
                v: int = V_FULL, k: int = K_FULL, n_docs: int = N_DOCS):
    """Run the serving path at (v, k) and check it; returns a dict of
    results (the main-path launch counts among them)."""
    from repro_torch.api import TopicModel
    from repro_torch.core.lightlda import LDAConfig
    from repro_torch.infer import ConcurrentEngine, EngineConfig, QueryEngine
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
    out["batches"] = batches
    if device == "cuda":
        if publish_counts["alias_build"] != 2:
            raise AssertionError("each publish must launch alias_build once")
        if b1 != ecfg.foldin.num_sweeps * batches:
            raise AssertionError(f"mh_sample launched {b1} times in "
                                 f"transform, expected sweeps x batches = "
                                 f"{ecfg.foldin.num_sweeps * batches}")
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
    # card against CPU: the same FrozenModel, the plain path, same seeds
    if device == "cuda":
        cpu_eng = QueryEngine(snap.to("cpu"), EngineConfig(max_batch=1))
        idx = list(range(8))
        cpu_theta = np.stack([r.theta for r in cpu_eng.infer(
            [docs[j] for j in idx], [seeds[j] for j in idx])])
        if not np.array_equal(cpu_theta, theta[idx]):
            raise AssertionError("card θ differs from CPU-plain θ: max "
                                 f"{np.abs(cpu_theta - theta[idx]).max()}")
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
        "request_p90_ms": out["p90_ms"], "request_p99_ms": out["p99_ms"], "launches": out["counts"],
        "checks": "ok", "card": card}}))
    out.update(model=model, docs=docs, seeds=seeds)
    return out


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


def kernel_report(torch, timer: Timer, serve: dict, card: str) -> list:
    from repro_torch.core import alias as alias_mod
    from repro_torch.kernels import alias_build, mh_sample, ref

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

    phi = model.snapshot.phi
    v, k = phi.shape
    got = alias_build.alias_build_cuda(phi)
    want = ref.alias_build_ref(phi)
    pmf_err = float((alias_mod.alias_pmf(got)
                     - alias_mod.alias_pmf(want)).abs().max())
    if not torch.allclose(alias_mod.alias_pmf(got), alias_mod.alias_pmf(want),
                          rtol=3e-5, atol=3e-6):
        raise AssertionError("alias_build pmf differs at the main path's "
                             "shapes")
    del got, want
    # once per publish, after phi_from_counts wrote 400 MB: cold
    ms = timer.ms(lambda: alias_build.alias_build_cuda(phi), reps=5,
                  before=timer.evict)
    plain_ms = timer.ms(lambda: ref.alias_build_ref(phi), reps=1,
                        device_only=False, before=timer.evict)
    rows.append(kernel_row("alias_build", "src/repro_torch/kernels/csrc/"
                           "alias_build.cu",
                           "src/repro/kernels/alias_build.py:38",
                           serve["counts"]["alias_build"], pmf_err, ms,
                           plain_ms, v * k * 12, v * k * 10))
    return rows


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes,
               flops) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def _device_us(event) -> float:
    return (getattr(event, "self_device_time_total", None)
            or getattr(event, "self_cuda_time_total", 0))


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
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=act) as prof:
        fold_in_batch(snap.model, w, valid, keys, snap.cfg, eng.ecfg.foldin)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = sum(_device_us(e) for e in events)
    launches = sum(e.count for e in events if _device_us(e) > 0)
    table = events.table(sort_by="self_device_time_total", row_limit=25)
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    (outdir / "serving_profile.txt").write_text(
        f"{card}\none fold-in batch [{mb} x {bucket}], wall {wall_ms:.3f} ms "
        f"(profiler on), device busy {dev_us / 1e3:.3f} ms\n\n{table}\n")
    mh = [e for e in events if "mh_sample" in e.key]
    if not dev_us or not mh:
        raise AssertionError("the profile of a fold-in batch shows no device "
                             "time or no mh_sample launch")
    log(json.dumps({"profile": {
        "batch": [mb, bucket], "wall_ms_profiled": wall_ms,
        "device_busy_ms": dev_us / 1e3,
        "device_idle_share": 1.0 - dev_us / 1e3 / wall_ms,
        "device_kernels": launches,
        "mh_sample_device_ms": sum(_device_us(e) for e in mh) / 1e3,
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
    logs = _build.build(["mh_sample", "alias_build"], ptxas_info=True)
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    check_kernels(torch)
    serve = serve_slice(torch, args.seed, card)
    timer = Timer(torch)
    rows = kernel_report(torch, timer, serve, card)
    profile_batch(torch, serve, card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
