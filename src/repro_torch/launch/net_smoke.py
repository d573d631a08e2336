"""Fault drill for the network parameter server (DESIGN.md section 15).

    PYTHONPATH=src python -m repro_torch.launch.net_smoke --workers 4

One self-contained localhost drill of everything the net plane promises,
with every worker's sweep on ``--device`` (default the card):

  1. a **reference** single-process streamed run (``_StreamPlane``) on a
     copy of the corpus;
  2. a real ``repro_torch.launch.ps_server`` subprocess + a ``WorkerPool``
     of N worker subprocesses, every worker running with
     ``FaultInjector.once_per_op`` -- at least one forced retry for every
     op type it uses (hello / acquire / pull_full / commit);
  3. one worker **SIGKILLed mid-epoch**; the pool evicts it, its lease
     re-queues, survivors drain the schedule;
  4. asserts: exactly-once **count conservation** (server counts ==
     histogram of the on-disk z -- bitwise, despite retries and the
     kill), dedup acks observed, and final stream-wide perplexity within
     tolerance of the reference run.

Exit code 0 only if every assertion holds.  Every wait is bounded, and the
server and the pool are stopped however the drill ends.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2])      # holds repro_torch/


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def wait_for_address(proc: subprocess.Popen, ready: str,
                     timeout: float = 60.0) -> str:
    """The ``host:port`` a ``launch.ps_server`` process writes to its
    ``--ready-file`` once listening (raises if it exits or times out)."""
    t0 = time.time()
    while True:
        if os.path.exists(ready):
            with open(ready) as f:
                address = f.read().strip()
            if address:
                return address
        if proc.poll() is not None:
            raise RuntimeError("ps_server exited before binding")
        if time.time() - t0 > timeout:
            raise TimeoutError(f"ps_server did not bind within {timeout}s")
        time.sleep(0.05)


def run_smoke(workers: int = 4, epochs: int = 2, topics: int = 8,
              ppl_tol: float = 0.2, device=None, log=print) -> dict:
    import numpy as np

    from repro_torch.api.session import _StreamPlane, seed_net_server
    from repro_torch.core import lightlda as lda
    from repro_torch.core import perplexity as ppl
    from repro_torch.data import corpus as corpus_mod
    from repro_torch.data import stream as stream_mod
    from repro_torch.device import resolve_device
    from repro_torch.ps.net import NetClient, WorkerConfig, WorkerPool, wire
    from repro_torch.train import async_exec

    dev = resolve_device(device)
    corp = corpus_mod.generate_lda_corpus(seed=0, num_docs=160,
                                          mean_doc_len=40, vocab_size=300,
                                          num_topics=6)
    tmp = tempfile.mkdtemp(prefix="net-smoke-")
    ref_dir, net_dir = os.path.join(tmp, "ref"), os.path.join(tmp, "net")
    for d in (ref_dir, net_dir):
        stream_mod.write_sharded(d, corp, tokens_per_shard=1024)
    cfg = lda.LDAConfig(num_topics=topics, vocab_size=300,
                        block_tokens=512, num_shards=1)
    srv_proc = pool = ctl = None
    try:
        # -- 1. reference: single-process streamed run --------------------
        log(f"[smoke] reference run: {epochs} epochs, single process on "
            f"{dev}")
        plane = _StreamPlane(ref_dir, cfg, async_exec.ExecConfig(), epochs,
                             seed=0, prefetch=False, log_fn=lambda *a: None,
                             device=dev)
        plane.setup()
        for visit in plane.schedule():
            plane.step(visit)
        ref_ppl = ppl.stream_training_perplexity(
            stream_mod.ShardedCorpusReader(ref_dir),
            plane.nwk.to_dense().cpu().numpy(),
            plane.nk.value.cpu().numpy(), cfg.alpha, cfg.beta, device=dev)
        log(f"[smoke] reference perplexity {ref_ppl:.2f}")

        # -- 2. real ps_server subprocess ---------------------------------
        ready = os.path.join(tmp, "ps.addr")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (_SRC, os.environ.get("PYTHONPATH", "")) if p))
        srv_proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.ps_server",
             "--stream-dir", net_dir, "--topics", str(topics),
             "--ready-file", ready, "--quiet"],
            env=env, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT)
        address = wait_for_address(srv_proc, ready)
        log(f"[smoke] ps_server at {address} (pid {srv_proc.pid})")

        # seed the stream + load the initial counts, as the net plane does
        reader = stream_mod.ShardedCorpusReader(net_dir)
        ctl = NetClient.connect(address, name="smoke-ctl", role="ctl")
        sched = seed_net_server(ctl, reader, cfg, 0, epochs,
                                workers=workers, device=dev)

        # -- 3. worker pool, every worker under fault injection -----------
        base = WorkerConfig(server=address, stream_dir=net_dir,
                            num_topics=topics, block_tokens=512, seed=0,
                            commit_hot_rows=32, fault="once_per_op",
                            device=str(dev))
        pool = WorkerPool(address, base, log_fn=log,
                          log_dir=os.path.join(tmp, "logs"))
        pool.start(workers)

        # wait until training is genuinely mid-flight, then SIGKILL one
        t0 = time.time()
        while True:
            st = ctl.status()
            done = (st.get("leases") or {}).get("done", 0)
            if 2 <= done < len(sched):
                break
            if done >= len(sched):
                log("[smoke] schedule drained before the kill window; "
                    "kill drill degraded to a no-op")
                break
            if time.time() - t0 > 300:
                raise TimeoutError(f"no progress for the kill window: {st}")
            time.sleep(0.02)
        pool.kill(0)
        status = pool.join(timeout=300)
        log(f"[smoke] final status: {json.dumps(status)}")

        # -- 4. the laws --------------------------------------------------
        nwk = ctl.pull_full(wire.MAT_NWK)
        nk = ctl.pull_full(wire.MAT_NK)
        rw, rk = stream_mod.rebuild_counts_from_stream(reader, topics)
        _check(np.array_equal(nwk, rw),
               "conservation violated: server nwk != histogram(on-disk z)")
        _check(np.array_equal(nk, rk),
               "conservation violated: server nk != histogram(on-disk z)")
        _check(int(nk.sum()) == corp.w.shape[0],
               f"token mass changed: {int(nk.sum())} != {corp.w.shape[0]}")
        leases = status["leases"]
        _check(leases["done"] == leases["total"], f"undrained: {leases}")
        # every worker's injected faults forced >= 1 retry per op type it
        # used; the dedup cache must have answered the mutating ones
        _check(status["dup_acks"] >= 1, f"no dedup acks: {status}")
        retries = [s.get("retries", 0) for s in pool.stats() if s]
        _check(bool(retries) and all(r >= 3 for r in retries),
               f"expected >= 3 forced retries per surviving worker "
               f"(hello/acquire/pull_full/commit faulted once each): "
               f"{retries}")

        net_ppl = ppl.stream_training_perplexity(reader, nwk, nk, cfg.alpha,
                                                 cfg.beta, device=dev)
        rel = abs(net_ppl - ref_ppl) / ref_ppl
        log(f"[smoke] net perplexity {net_ppl:.2f} vs reference "
            f"{ref_ppl:.2f} (rel diff {rel:.3f})")
        _check(rel < ppl_tol,
               f"perplexity diverged: {net_ppl:.2f} vs {ref_ppl:.2f}")
        out = {"workers": workers, "device": str(dev),
               "visits": leases["total"], "reassigned": leases["reassigned"],
               "dup_acks": status["dup_acks"], "worker_retries": retries,
               "ref_perplexity": float(ref_ppl),
               "net_perplexity": float(net_ppl), "rel_diff": float(rel)}
        log(f"[smoke] PASS {json.dumps(out)}")
        return out
    finally:
        if pool is not None:
            pool.close()
        if ctl is not None:
            ctl.close()
        if srv_proc is not None:
            srv_proc.terminate()
            try:
                srv_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                srv_proc.kill()
                srv_proc.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--topics", type=int, default=8)
    ap.add_argument("--ppl-tol", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="where the workers and the reference run sweep: "
                         "'cuda' (default: the card) or 'cpu'")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        ap.error(f"no CUDA device available for --device {args.device}: "
                 "pass --device cpu to run the plain PyTorch path")
    run_smoke(workers=args.workers, epochs=args.epochs, topics=args.topics,
              ppl_tol=args.ppl_tol, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
