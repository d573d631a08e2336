"""The ranks of an SPMD training run, one process each.

The paper's layout on ``torch.distributed``: every rank is a worker that
samples its own document partition, and the ranks of each model row are
the servers that hold ``n_wk`` in cyclic row shards (``launch.mesh``).
Rank 0 is the process that called ``Session.run()``; ``SpmdRun`` starts
ranks 1..W-1 as fresh interpreters (``python -m
repro_torch.ps.spmd_worker <run_dir> <rank>``; a process that has
initialised CUDA is never forked) and drives the run.

Every rank runs the same ``RankProgram``.  The helpers run a *command
loop*: before each collective step rank 0 broadcasts a small op code on
the mesh's gloo control group -- a sweep, a stream visit, a gather of the
counts for a view or for the result, a perplexity, the rank statistics,
finish -- and every rank then performs that step.  A callback on rank 0
that reads the counts therefore issues a step of its own, and can never
leave a collective half-joined.

The discipline of ``ps/net/pool.py``: each helper writes to a log file of
its own (``SpmdRun.log_dir``), never to a pipe; the process group meets
through a ``FileStore`` in the run's temporary directory (no fixed port);
every wait is bounded (``timeout_s``); ``SpmdRun.close`` tears everything
down however the run ended, and a helper dies with rank 0 (the parent-death
signal).  Rank 0 checks that every helper lives before each step, so a
helper that dies makes ``Session.run()`` raise at the next step at the
latest, or, inside a collective, within the process group's timeout.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import (WORLD, Mesh, rank_device,
                                     transport_for)

OP_SWEEP, OP_VISIT, OP_GATHER, OP_PPL, OP_STATS, OP_RESULT, OP_FINISH = \
    range(1, 8)

# one intra-op thread per helper: the ranks share the host's cores
_ENV_CAPS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
             "MKL_NUM_THREADS": "1"}
_SRC = str(Path(__file__).resolve().parents[2])     # holds repro_torch/
_WAIT_S = 30.0


class RankProgram:
    """One rank's part of an SPMD run.  ``spec`` (see ``SpmdRun``) says
    which plane: ``"spmd"`` (the in-memory corpus, partitioned by
    ``shard_tokens``) or ``"stream_spmd"`` (a visit feeds W consecutive
    scheduled stream shards to the W ranks).  ``step(op, arg)`` performs
    one op of the command loop; what it returns matters on rank 0 only."""

    def __init__(self, mesh: Mesh, spec: dict):
        from repro_torch.api import session as sess

        self.mesh = mesh
        self.spec = spec
        self.cfg = spec["cfg"]
        self.dev = mesh.device
        exec_cfg = spec["exec_cfg"]
        self.route = exec_cfg.resolve_route(self.cfg.V)
        self.sweep_fn = sess.make_spmd_sweep(
            mesh, self.cfg, staleness=exec_cfg.staleness, route=self.route)
        self.stats = {"sweep_ms": [], "pull_ms": [], "collective_ms": [],
                      "reduce_ms": [], "gather_ms": []}
        self.steps = 0

    # -- setup ---------------------------------------------------------------
    def setup(self, init=None) -> None:
        """Build this rank's state.  ``init``: rank 0's initial ``(nwk
        physical, nk)`` of a stream run (None on the other ranks, which
        receive them)."""
        from repro_torch import rng as jrng
        from repro_torch.api import session as sess
        from repro_torch.kernels import ops

        mesh, cfg, dev = self.mesh, self.cfg, self.dev
        r = mesh.rank
        if self.spec["kind"] == "spmd":
            key = jrng.PRNGKey(self.spec["seed"], dev)
            (w, d, valid, ds, dl, z, ndk, nwk,
             nk) = sess.init_distributed_state(self.spec["corpus"], cfg,
                                               mesh.world, key, device=dev)
            self.w, self.d, self.valid = w[r], d[r], valid[r]
            self.doc_start, self.doc_len = ds[r], dl[r]
            self.z, self.ndk = z[r].clone(), ndk[r].clone()
            self.nwk = self._local(nwk.value)
            self.nk = nk
            self.key = key
            del w, d, valid, ds, dl, z, ndk, nwk
        else:
            from repro_torch.data import stream as stream_mod

            self.reader = stream_mod.ShardedCorpusReader(
                self.spec["stream_dir"])
            loader = stream_mod.StreamingLoader(
                self.reader, seed=self.spec["seed"], prefetch=False)
            self.sched = loader.schedule(stream_mod.Cursor(0, 0),
                                         self.spec["epochs"])
            if init is None:
                from repro_torch.core.pserver import CyclicLayout
                pad = CyclicLayout(cfg.V, cfg.num_shards).pad_rows
                init = (torch.empty((pad, cfg.K), dtype=torch.int32,
                                    device=dev),
                        torch.empty(cfg.K, dtype=torch.int32, device=dev))
            phys, nk = (mesh.broadcast(x.to(dev).contiguous(), tag="init")
                        for x in init)
            self.nwk, self.nk = self._local(phys), nk
            self.valid_dev = torch.arange(self.reader.meta.tokens_per_shard,
                                          device=dev)
            self.last = None
        self._sync()
        self._launch0 = ops.launch_counts()
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)

    def _local(self, phys: torch.Tensor) -> torch.Tensor:
        """This server's rows of a full physical table."""
        rps = phys.shape[0] // self.mesh.model
        i = self.mesh.model_idx
        return phys[i * rps:(i + 1) * rps].clone()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the command loop ------------------------------------------------------
    def step(self, op: int, arg: int = 0):
        if op == OP_SWEEP:
            return self._timed(self._sweep, arg)
        if op == OP_VISIT:
            return self._timed(self._visit, arg)
        if op == OP_GATHER:
            return self.gather_nwk()
        if op == OP_PPL:
            return self.perplexity()
        if op == OP_STATS:
            return self.mesh.gather_object(self.rank_stats())
        if op == OP_RESULT:
            return self.result()
        if op == OP_FINISH:
            return None
        raise ValueError(f"unknown SPMD op {op}")

    def _timed(self, fn, arg):
        before = dict(self.mesh.stats)
        t0 = time.perf_counter()
        fn(arg)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        diff = {k: v - before.get(k, 0.0) for k, v in self.mesh.stats.items()}
        self.stats["sweep_ms"].append(ms)
        self.stats["pull_ms"].append(diff.get("pull", 0.0))
        self.stats["reduce_ms"].append(diff.get("reduce", 0.0))
        self.stats["gather_ms"].append(diff.get("gather", 0.0))
        self.stats["collective_ms"].append(diff.get("reduce", 0.0)
                                           + diff.get("gather", 0.0))
        self.steps += 1

    def _sweep(self, i: int) -> None:
        from repro_torch import rng as jrng

        self.key, sub = jrng.split(self.key)
        key = jrng.split(sub, self.mesh.world)[self.mesh.rank]
        self.z, self.ndk, self.nwk, self.nk = self.sweep_fn(
            self.w, self.d, self.z, self.valid, self.doc_start, self.doc_len,
            self.ndk, self.nwk, self.nk, key)

    def group(self, g: int) -> list:
        """Visit ``g``'s shards, one per rank: ``[(cursor, shard_id)]``."""
        w = self.mesh.world
        return self.sched[g * w:(g + 1) * w]

    def _visit(self, g: int) -> None:
        from repro_torch import rng as jrng
        from repro_torch.api import session as sess

        cfg, dev, meta = self.cfg, self.dev, self.reader.meta
        group = self.group(g)
        _, sid = group[self.mesh.rank]
        shard = self.reader.shard(sid, mmap=False)
        if shard.z is None:
            raise FileNotFoundError(
                f"shard {sid} has no z file; stream was never initialised")
        n = shard.n_tokens
        w, d, z, ds, dl = (torch.from_numpy(np.asarray(x)).to(dev)
                           for x in (shard.w, shard.d, shard.z,
                                     shard.doc_start, shard.doc_len))
        valid = self.valid_dev < n
        # the valid tokens are the first n: histogram those alone
        ndk = torch.zeros(meta.doc_cap * cfg.K, dtype=torch.int32,
                          device=dev).index_add_(
            0, d[:n].long() * cfg.K + z[:n].long(),
            torch.ones(n, dtype=torch.int32, device=dev)
        ).view(meta.doc_cap, cfg.K)
        cur0 = group[0][0]
        key = jrng.split(sess.stream_sweep_key(self.spec["seed"], cur0.epoch,
                                               cur0.pos, dev),
                         self.mesh.world)[self.mesh.rank]
        z2, ndk2, self.nwk, self.nk = self.sweep_fn(
            w, d, z, valid, ds, dl, ndk, self.nwk, self.nk, key)
        self.reader.write_z(sid, z2.cpu().numpy())
        self.last = (w, d, valid, ndk2)
        self.mesh.barrier()        # every z file written before rank 0 goes on

    # -- reads ---------------------------------------------------------------
    def gather_nwk(self) -> torch.Tensor:
        """The full physical ``n_wk`` (an all-gather over the model axis;
        each data row holds the same copy)."""
        return self.mesh.all_gather(self.nwk, "model", tag="view")

    def _gather_tokens(self, w, d, valid, ndk):
        m = self.mesh
        return (m.all_gather(w, WORLD, tag="view"),
                m.all_gather(d, WORLD, tag="view"),
                m.all_gather(valid.to(torch.int32), WORLD,
                             tag="view").bool(),
                m.all_gather(ndk, WORLD, tag="view"))

    def perplexity(self) -> Optional[float]:
        """Training perplexity of the whole mesh's tokens (the JAX
        package's ``training_perplexity`` over the stacked workers: doc ids
        offset by worker), on rank 0; None on the others."""
        from repro_torch.core import perplexity as ppl
        from repro_torch.core.pserver import DistributedMatrix

        cfg = self.cfg
        if self.spec["kind"] == "spmd":
            parts = (self.w, self.d, self.valid, self.ndk)
        else:
            parts = self.last
        dmax = parts[3].shape[0]
        w, d, valid, ndk = self._gather_tokens(*parts)
        phys = self.gather_nwk()
        if self.mesh.rank != 0:
            return None
        offs = torch.arange(self.mesh.world, device=d.device)[:, None] * dmax
        d = (d.view(self.mesh.world, -1) + offs).reshape(-1)
        full = DistributedMatrix(phys, cfg.V, cfg.num_shards).to_dense()
        return float(ppl.training_perplexity(w, d, valid, ndk, full, self.nk,
                                             cfg.alpha, cfg.beta))

    def result(self) -> Optional[dict]:
        """The counts on rank 0: the full physical ``n_wk`` and ``n_k``,
        and on the memory plane the whole mesh's tokens as one state's
        arrays (worker ``r``'s slots at ``[r*npad, (r+1)*npad)``, its doc
        ids offset by ``r*dmax``)."""
        out = {"nwk_phys": self.gather_nwk(), "nk": self.nk}
        if self.spec["kind"] == "spmd":
            w, d, valid, ndk = self._gather_tokens(self.w, self.d,
                                                   self.valid, self.ndk)
            z = self.mesh.all_gather(self.z, WORLD, tag="view")
            ds = self.mesh.all_gather(self.doc_start, WORLD, tag="view")
            dl = self.mesh.all_gather(self.doc_len, WORLD, tag="view")
            world, npad, dmax = (self.mesh.world, self.w.shape[0],
                                 self.ndk.shape[0])
            r = torch.arange(world, device=d.device)[:, None]
            out.update(
                w=w, z=z, valid=valid, ndk=ndk, doc_len=dl,
                d=(d.view(world, -1) + r * dmax).reshape(-1),
                doc_start=(ds.view(world, -1) + r * npad).reshape(-1))
        return out if self.mesh.rank == 0 else None

    def rank_stats(self) -> dict:
        """This rank's launches since its state was built, peak device
        memory and per-step host ms (the step, the pull's all-gather, the
        group collectives: the sums, the coordinate all-gathers and both
        together)."""
        from repro_torch.kernels import ops

        on_card = self.dev.type == "cuda"
        return {"rank": self.mesh.rank, "data_idx": self.mesh.data_idx,
                "model_idx": self.mesh.model_idx, "pid": os.getpid(),
                "device": (torch.cuda.get_device_name(self.dev) if on_card
                           else str(self.dev)),
                "launches": {k: n - self._launch0[k] for k, n in
                             ops.launch_counts().items()},
                "steps": self.steps,
                "max_memory_allocated": (
                    torch.cuda.max_memory_allocated(self.dev) if on_card
                    else None),
                **self.stats}


class SpmdRun:
    """Rank 0's side of an SPMD run: starts the helpers, joins the mesh,
    and drives every rank through ``do(op, arg)``.

    ``spec`` holds what every rank needs: ``kind``, ``cfg`` (an
    ``LDAConfig`` whose ``num_shards`` is the model axis), ``exec_cfg``,
    ``seed``, ``data``/``model`` and, for ``"spmd"``, the ``corpus``; for
    ``"stream_spmd"``, ``stream_dir`` and ``epochs``.  It reaches the
    helpers through a file in the run's temporary directory.  ``device``
    is rank 0's device; the transport follows from it and the rank count
    (``launch.mesh.transport_for``) unless ``transport`` names one (a
    caller that compares two transports on one layout)."""

    worker_module = "repro_torch.ps.spmd_worker"   # the helpers' program
    build_kernels = True         # build csrc/ before the helpers start

    def __init__(self, spec: dict, device: torch.device, *, log_fn=None,
                 timeout_s: float = 600.0, transport: Optional[str] = None):
        self.spec = dict(spec)
        self.world = spec["data"] * spec["model"]
        self.transport = transport or transport_for(self.world, device)
        self.device = rank_device(self.transport, device, 0)
        self.log_fn = log_fn or (lambda *a: None)
        self.timeout_s = float(timeout_s)
        self.dir: Optional[str] = None
        self.procs: List[subprocess.Popen] = []
        self.mesh: Optional[Mesh] = None
        self.program: Optional[RankProgram] = None
        self.finished = False

    @property
    def log_dir(self) -> Optional[str]:
        return self.dir

    @property
    def helper_pids(self) -> List[int]:
        return [p.pid for p in self.procs]

    def start(self, init=None) -> "SpmdRun":
        """Spawn the helpers, join the mesh, build every rank's state
        (``init``: a stream run's initial ``(nwk physical, nk)``)."""
        self.dir = tempfile.mkdtemp(prefix="repro-spmd-")
        spec = dict(self.spec, transport=self.transport,
                    device=str(self.device), timeout_s=self.timeout_s)
        with open(os.path.join(self.dir, "spec.pkl"), "wb") as f:
            pickle.dump(spec, f)
        if self.device.type == "cuda" and self.build_kernels:
            from repro_torch.kernels import _build
            _build.build(_build.SOURCES)     # once, before the helpers
        path = os.pathsep.join(p for p in (_SRC, os.environ.get(
            "PYTHONPATH", "")) if p)
        env = dict(os.environ, **_ENV_CAPS, PYTHONPATH=path)
        for r in range(1, self.world):
            log = os.path.join(self.dir, f"rank{r}.log")
            with open(log, "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", self.worker_module,
                     self.dir, str(r), str(os.getpid())],
                    env=env, cwd=os.getcwd(), stdin=subprocess.DEVNULL,
                    stdout=out, stderr=subprocess.STDOUT))
        self._await_ready()
        self.mesh = Mesh.init(0, spec["data"], spec["model"], self.transport,
                              self.device, os.path.join(self.dir, "store"),
                              self.timeout_s)
        self.program = self.make_program(self.mesh, spec)
        self.program.setup(init)
        self.log_fn(f"[spmd] {self.world} ranks over {self.transport} "
                    f"(helper logs in {self.dir})")
        return self

    @staticmethod
    def make_program(mesh: Mesh, spec: dict):
        return RankProgram(mesh, spec)

    def _await_ready(self) -> None:
        """Wait (bounded) until every helper has imported its modules and
        is about to join the mesh; a helper that dies first raises here
        with its log."""
        deadline = time.time() + self.timeout_s
        pending = set(range(1, self.world))
        while pending:
            self.check_alive()
            pending = {r for r in pending if not os.path.exists(
                os.path.join(self.dir, f"ready{r}"))}
            if pending and time.time() > deadline:
                raise TimeoutError(f"SPMD ranks {sorted(pending)} not ready "
                                   f"within {self.timeout_s}s; logs in "
                                   f"{self.dir}")
            time.sleep(0.02)

    def check_alive(self) -> None:
        """Raise if a helper has exited, with the log of every helper that
        has (the one that failed first takes its peers' collectives down
        with it, and need not be the lowest rank)."""
        dead = [(r, p) for r, p in enumerate(self.procs, start=1)
                if p.poll() is not None]
        if dead:
            raise RuntimeError("\n".join(
                f"SPMD rank {r} (pid {p.pid}) exited with rc {p.returncode}"
                f"; its log:\n{_tail(os.path.join(self.dir, f'rank{r}.log'))}"
                for r, p in dead))

    def do(self, op: int, arg: int = 0):
        """Run one op on every rank; returns rank 0's result."""
        if self.finished:
            raise RuntimeError("the SPMD run has finished: its ranks are "
                               "gone")
        self.check_alive()
        if self.world > 1:
            self.mesh.send_op(op, arg)
        out = self.program.step(op, arg)
        if op == OP_FINISH:
            self.finished = True
            self._join()
        return out

    def _join(self) -> None:
        for p in self.procs:
            try:
                rc = p.wait(timeout=_WAIT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=_WAIT_S)
                rc = "killed"
            if rc != 0:
                raise RuntimeError(f"SPMD helper pid {p.pid} ended with "
                                   f"{rc}; logs in {self.dir}")

    def close(self) -> None:
        """Kill any helper still running, leave the process group, remove
        the run's directory (idempotent; called however the run ended)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            try:
                p.wait(timeout=_WAIT_S)
            except subprocess.TimeoutExpired:
                pass
        if self.mesh is not None:
            self.mesh.close()
            self.mesh = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return "(no log)"


def _die_with_parent(parent: int) -> None:
    """Ask the kernel to SIGKILL this process when its parent dies, so a
    helper never outlives rank 0 (Linux; elsewhere a no-op)."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)          # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.getppid() != parent:                 # the parent died already
        os._exit(1)


def main(argv=None) -> int:
    """A helper rank: ``python -m repro_torch.ps.spmd_worker <run_dir>
    <rank> <parent pid>``."""
    return run_helper(argv, RankProgram)


def run_helper(argv, program_cls) -> int:
    """A helper rank's life: join the mesh, build ``program_cls(mesh,
    spec)``, run rank 0's ops until the finish op."""
    run_dir, rank, parent = (argv or sys.argv[1:])[:3]
    rank = int(rank)
    _die_with_parent(int(parent))
    torch.set_num_threads(1)
    with open(os.path.join(run_dir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    device = rank_device(spec["transport"], torch.device(spec["device"]),
                         rank)
    open(os.path.join(run_dir, f"ready{rank}"), "w").close()
    mesh = Mesh.init(rank, spec["data"], spec["model"], spec["transport"],
                     device, os.path.join(run_dir, "store"),
                     spec["timeout_s"])
    try:
        program = program_cls(mesh, spec)
        program.setup()
        while True:
            op, arg = mesh.recv_op()
            program.step(op, arg)
            if op == OP_FINISH:
                break
        print(json.dumps({"rank": rank, "steps": program.steps}), flush=True)
    finally:
        mesh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
