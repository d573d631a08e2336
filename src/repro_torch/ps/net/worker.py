"""The network worker: one member of the elastic pool.

A worker owns no global state.  Per granted lease it (1) reads the
shard's persisted assignments, (2) pulls a fresh count snapshot from the
server and copies it to its device, (3) runs the *existing* stream
executor sweep (``make_stream_executor``, snapshot or blocked) against
local in-process handles -- with ``stream_sweep_key(seed, epoch, pos)``,
so the draw depends only on the schedule position, never on which worker
runs it -- and (4) ships the transactional commit: the z-diff's count
deltas plus the new assignments, applied/persisted atomically server
side.  Because the deltas are plain integer adds, any interleaving of
workers conserves counts; because redo is deterministic, a worker killed
mid-lease costs only wall clock.

The sweep runs on ``WorkerConfig.device`` (None: the card), so every
visit launches the ``mh_draws_train``, ``alias_build``, ``mh_sample`` and
``delta_push`` kernels there.  The commit is computed on the host in
numpy (``_commit_deltas``), as the JAX package's worker computes it.

The module doubles as the subprocess entry point
(``python -m repro_torch.ps.net.worker <config.json>``) that ``WorkerPool``
spawns, and exports ``run_worker`` for in-thread use in tests.  Its last
stdout line is the stats JSON: the reference's keys, plus the device, the
kernels' launch counts in this process, the median host ms of each part
of a visit and the peak device memory.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Optional

from repro_torch.ps.net import wire
from repro_torch.ps.net.transport import (FaultInjector, NetClient,
                                          TransportConfig)

#: The host-timed parts of a visit, in order (``visit_ms`` in the stats).
VISIT_PARTS = ("acquire", "read_shard", "pull_full", "h2d", "sweep", "d2h",
               "commit_deltas", "commit")


@dataclasses.dataclass
class WorkerConfig:
    """Everything one worker process needs, JSON-serialisable.  Every field
    of the JAX package's config is here, so a config it wrote loads;
    ``use_kernels`` is read and ignored (a CUDA tensor always runs the
    kernel), and ``device`` is the port's own: None is the card, and the
    tests pass ``"cpu"``."""

    server: str                     # "host:port"
    stream_dir: str
    num_topics: int
    alpha: float = 0.1
    beta: float = 0.01
    mh_steps: int = 2
    block_tokens: int = 8192
    model_blocks: int = 0
    staleness: int = 0
    hot_words: Optional[int] = None
    use_kernels: bool = False
    seed: int = 0
    name: str = ""
    commit_hot_rows: int = 0        # rows committed as a dense prefix
    slow_ms: float = 0.0            # straggler emulation: sleep per visit
    delay_ms: float = 0.0           # emulated per-op RTT (TransportConfig)
    timeout_s: float = 15.0
    retries: int = 6
    fault: str = ""                 # FaultInjector.from_spec
    poll_s: float = 0.05            # acquire back-off while waiting
    warmup: bool = True             # load the kernels before registering
    device: Optional[str] = None    # None: the card

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "WorkerConfig":
        return cls(**json.loads(text))


def _commit_deltas(w, z_old, z_new, changed, vocab, k, hot_rows):
    """Host-side diff of one sweep: hot-prefix dense delta, cold COO
    triple, and the nk delta -- the same +-1 integer adds every
    ``PushRoute`` plans, computed from the assignment diff."""
    import numpy as np

    wc = w[changed]
    zo = z_old[changed]
    zn = z_new[changed]
    hot = wc < hot_rows
    dense = np.zeros((hot_rows, k), wire.I4)
    if hot_rows and hot.any():
        np.add.at(dense, (wc[hot], zo[hot]), -1)
        np.add.at(dense, (wc[hot], zn[hot]), 1)
    wcold = wc[~hot]
    n = wcold.shape[0]
    rows = np.concatenate([wcold, wcold]).astype(wire.I4)
    cols = np.concatenate([zo[~hot], zn[~hot]]).astype(wire.I4)
    vals = np.concatenate([np.full(n, -1, wire.I4),
                           np.full(n, 1, wire.I4)])
    nk_delta = (np.bincount(zn, minlength=k)
                - np.bincount(zo, minlength=k)).astype(wire.I4)
    return dense, (rows, cols, vals), nk_delta


def run_worker(cfg: WorkerConfig, *, log_fn=None) -> dict:
    """Join the pool at ``cfg.server`` and work the lease queue dry.

    Returns run stats: the JAX package's ``{"worker", "visits",
    "superseded", "retries", "reconnects"}`` plus ``device``,
    ``launches`` (``ops.KERNELS`` counts of this process since the
    warm-up), ``tokens``, ``wall`` (epoch seconds of the first lease
    request that was granted and of the last commit), ``visit_ms`` (median
    host ms per part of a visit, ``VISIT_PARTS``) and
    ``max_memory_allocated`` (bytes, on a card; else None).
    """
    # torch imported here: the subprocess pays it once, before hello
    import numpy as np
    import torch

    from repro_torch.api.session import stream_sweep_key
    from repro_torch.core import lightlda as lda
    from repro_torch.data import stream as stream_mod
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.ps.client import PSClient
    from repro_torch.train import async_exec

    log = log_fn or (lambda *a: None)
    dev = resolve_device(cfg.device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    reader = stream_mod.ShardedCorpusReader(cfg.stream_dir)
    meta = reader.meta
    lcfg = lda.LDAConfig(num_topics=cfg.num_topics,
                         vocab_size=meta.vocab_size, alpha=cfg.alpha,
                         beta=cfg.beta, mh_steps=cfg.mh_steps,
                         block_tokens=cfg.block_tokens, num_shards=1)
    ecfg = async_exec.ExecConfig(staleness=cfg.staleness,
                                 hot_words=cfg.hot_words,
                                 model_blocks=cfg.model_blocks)
    client = PSClient.create(num_shards=1)
    k, n_cap = lcfg.K, meta.tokens_per_shard
    valid_np = np.arange(n_cap)
    valid_dev = torch.arange(n_cap, device=dev)

    def to_dev(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(dev)

    def sweep(state, key, w_np, n):
        if build_index is None:
            return step_fn(state, key)
        idx, bval = build_index(w_np, valid_np < n)
        return step_fn(state, key, idx.to(dev), bval.to(dev),
                       bval.sum(1).tolist())

    # one step on zeros before registering: the server's start gate holds
    # every worker until the pool is complete, so CUDA context creation
    # and the kernels' first load stay out of the training window
    step_fn = build_index = None
    if cfg.warmup:
        zeros_m = client.matrix_from_dense(
            torch.zeros((meta.vocab_size, k), dtype=torch.int32, device=dev))
        step_fn, build_index, _ = async_exec.make_stream_executor(
            lcfg, ecfg, zeros_m.layout)
        zi = torch.zeros(n_cap, dtype=torch.int32, device=dev)
        zd = torch.zeros(meta.doc_cap, dtype=torch.int32, device=dev)
        st0 = lda.SamplerState(
            zi, zi, zi, torch.zeros(n_cap, dtype=torch.bool, device=dev),
            zd, zd, zeros_m,
            client.wrap_vector(torch.zeros(k, dtype=torch.int32,
                                           device=dev)),
            torch.zeros((meta.doc_cap, k), dtype=torch.int32, device=dev))
        sweep(st0, stream_sweep_key(0, 0, 0, dev),
              np.zeros(n_cap, np.int32), 0)
        sync()
        del zeros_m, st0
    ops.reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    tcfg = TransportConfig(timeout=cfg.timeout_s, retries=cfg.retries,
                           delay_ms=cfg.delay_ms)
    fault = FaultInjector.from_spec(cfg.fault)
    net = NetClient.connect(cfg.server, name=cfg.name, config=tcfg,
                            fault=fault)
    hello = net.meta
    if hello["vocab"] != meta.vocab_size:
        raise ValueError(f"server vocab {hello['vocab']} != stream vocab "
                         f"{meta.vocab_size}")
    visits = superseded = tokens = 0
    ms = {p: [] for p in VISIT_PARTS}
    wall = [None, None]         # epoch seconds: first lease asked, last commit
    try:
        while True:
            t0, w0 = time.perf_counter(), time.time()
            st, lease = net.acquire()
            if st == "done":
                break
            if st != "lease":
                time.sleep(cfg.poll_s)
                continue
            if wall[0] is None:
                wall[0] = w0
            t = [t0, time.perf_counter()]
            shard = reader.shard(lease.shard_id, mmap=False)
            if shard.z is None:
                raise FileNotFoundError(
                    f"shard {lease.shard_id} has no z file; stream was "
                    f"never initialised")
            z_old = np.array(shard.z)
            n = shard.n_tokens
            t.append(time.perf_counter())
            nwk_np = net.pull_full(wire.MAT_NWK)
            nk_np = net.pull_full(wire.MAT_NK)
            t.append(time.perf_counter())
            nwk = client.matrix_from_dense(to_dev(nwk_np))
            nk = client.wrap_vector(to_dev(nk_np))
            if step_fn is None:
                step_fn, build_index, _ = async_exec.make_stream_executor(
                    lcfg, ecfg, nwk.layout)
            w, d, z, doc_start, doc_len = (
                to_dev(x) for x in (shard.w, shard.d, z_old, shard.doc_start,
                                    shard.doc_len))
            # the valid tokens are the first n (as _StreamPlane rebuilds it)
            ndk = torch.zeros(meta.doc_cap * k, dtype=torch.int32,
                              device=dev).index_add_(
                0, d[:n].long() * k + z[:n].long(),
                torch.ones(n, dtype=torch.int32, device=dev)
            ).view(meta.doc_cap, k)
            state = lda.SamplerState(w, d, z, valid_dev < n, doc_start,
                                     doc_len, nwk, nk, ndk)
            sync()
            t.append(time.perf_counter())
            # the same (seed, schedule-position) key _StreamPlane uses --
            # the sweep is identical whichever worker runs it
            key = stream_sweep_key(cfg.seed, lease.epoch, lease.pos, dev)
            state = sweep(state, key, shard.w, n)
            sync()
            t.append(time.perf_counter())
            z_new = state.z.cpu().numpy()
            t.append(time.perf_counter())
            del state, nwk, nk, ndk
            if cfg.slow_ms:
                time.sleep(cfg.slow_ms / 1000.0)
            changed = (z_new != z_old) & (valid_np < n)
            dense, coo, nk_delta = _commit_deltas(
                np.asarray(shard.w), z_old, z_new, changed, meta.vocab_size,
                k, cfg.commit_hot_rows)
            t.append(time.perf_counter())
            applied = net.commit(lease.lease_id, dense, coo, nk_delta, z_new)
            t.append(time.perf_counter())
            wall[1] = time.time()
            for part, a, b in zip(VISIT_PARTS, t, t[1:]):
                ms[part].append((b - a) * 1e3)
            visits += 1
            tokens += n
            if not applied:
                superseded += 1
            log(f"[worker {net.t.worker_id}] visit epoch "
                f"{lease.epoch} pos {lease.pos} shard {lease.shard_id} "
                f"{'applied' if applied else 'SUPERSEDED'}")
    finally:
        net.close()
    return {"worker": net.t.worker_id, "visits": visits,
            "superseded": superseded, "retries": net.t.retries,
            "reconnects": net.t.reconnects,
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else str(dev)),
            "launches": ops.launch_counts(), "tokens": tokens,
            "wall": wall,
            "visit_ms": {p: (float(np.median(v)) if v else None)
                         for p, v in ms.items()},
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if on_card else None)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.ps.net.worker "
              "<config.json|json>", file=sys.stderr)
        return 2
    text = argv[0]
    if not text.lstrip().startswith("{"):
        with open(text) as f:
            text = f.read()
    cfg = WorkerConfig.from_json(text)
    # quiet by default; REPRO_NET_WORKER_VERBOSE prints a line per visit
    import os
    verbose = os.environ.get("REPRO_NET_WORKER_VERBOSE")
    log = ((lambda *a: print(*a, flush=True)) if verbose
           else (lambda *a: None))
    stats = run_worker(cfg, log_fn=log)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
