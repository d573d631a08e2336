"""Elastic localhost worker pool for the network parameter server.

``WorkerPool`` spawns ``python -m repro_torch.ps.net.worker`` subprocesses
against one ``PSServer`` and supervises them: liveness is polled, a dead
worker (crash or ``kill()`` -- the fault drills SIGKILL one mid-epoch) is
*evicted* at the server, which re-queues its active lease and orphans its
statically assigned visits so the survivors finish the schedule.  Workers
can join late (``add_worker``) and leave between shard groups -- the
elasticity the paper gets from running workers and servers as independent
processes (section 2.1).

Each worker is a fresh interpreter (``subprocess.Popen``): a process that
has initialised CUDA must never be forked.  Its output goes to a log file
of its own (``log_dir``), never to a pipe the pool would have to drain, and
the stats JSON is read from that file's last JSON line once it exits.  When
the workers run on the card, ``start`` builds every kernel in this process
first, so N workers do not each run nvcc at once.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.ps.net.transport import NetClient
from repro_torch.ps.net.worker import WorkerConfig

# one BLAS thread per worker: the pool multiplexes cores across
# processes, not within one
_ENV_CAPS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
             "MKL_NUM_THREADS": "1"}
_SRC = str(Path(__file__).resolve().parents[3])     # holds repro_torch/
_WAIT_S = 30.0


class _Proc:
    __slots__ = ("proc", "cfg", "log", "evicted", "stats")

    def __init__(self, proc: subprocess.Popen, cfg: WorkerConfig, log: str):
        self.proc = proc
        self.cfg = cfg
        self.log = log
        self.evicted = False
        self.stats: Optional[dict] = None

    def output(self) -> str:
        with open(self.log, errors="replace") as f:
            return f.read()


class WorkerPool:
    """Supervise N worker subprocesses against one server address."""

    def __init__(self, server: str, base_cfg: WorkerConfig, *,
                 env: Optional[Dict[str, str]] = None, log_fn=None,
                 log_dir: Optional[str] = None):
        self.server = server
        self.base_cfg = base_cfg
        path = os.pathsep.join(p for p in (_SRC, os.environ.get(
            "PYTHONPATH", "")) if p)
        self.env = dict(os.environ, **_ENV_CAPS, PYTHONPATH=path,
                        **(env or {}))
        self.log_fn = log_fn or (lambda *a: None)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="repro-pool-")
        os.makedirs(self.log_dir, exist_ok=True)
        self.procs: List[_Proc] = []
        self._ctl: Optional[NetClient] = None

    # -- control-plane client (evictions) ------------------------------------
    def _control(self) -> NetClient:
        if self._ctl is None:
            self._ctl = NetClient.connect(self.server, name="pool-ctl",
                                          role="ctl")
        return self._ctl

    # -- membership -----------------------------------------------------------
    def add_worker(self, **overrides) -> int:
        """Spawn one worker subprocess; returns its pool index."""
        i = len(self.procs)
        cfg = WorkerConfig(**{**self.base_cfg.__dict__, **overrides,
                              "name": overrides.get("name", f"w{i}")})
        log = os.path.join(self.log_dir, f"{cfg.name}.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.ps.net.worker",
                 cfg.to_json()],
                env=self.env, cwd=os.getcwd(), stdin=subprocess.DEVNULL,
                stdout=out, stderr=subprocess.STDOUT)
        self.procs.append(_Proc(proc, cfg, log))
        self.log_fn(f"[pool] spawned worker {i} (pid {proc.pid})")
        return i

    def start(self, n: int, **overrides) -> "WorkerPool":
        device = {**self.base_cfg.__dict__, **overrides}["device"]
        if str(device or "cuda").startswith("cuda"):
            from repro_torch.kernels import _build
            _build.build(_build.SOURCES)
        for _ in range(n):
            self.add_worker(**overrides)
        return self

    def kill(self, i: int) -> None:
        """SIGKILL worker ``i`` (the fault drill -- no cleanup runs)."""
        p = self.procs[i].proc
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)
            p.wait(timeout=_WAIT_S)
            self.log_fn(f"[pool] SIGKILLed worker {i} (pid {p.pid})")

    def alive(self) -> int:
        return sum(p.proc.poll() is None for p in self.procs)

    # -- supervision -----------------------------------------------------------
    def reap(self) -> None:
        """Evict every newly dead worker at the server so its leases
        re-queue.  A clean exit (rc 0) needs no eviction -- its queue is
        already drained -- but evicting is harmless (no active leases)."""
        for i, rec in enumerate(self.procs):
            rc = rec.proc.poll()
            if rc is None or rec.evicted:
                continue
            rec.evicted = True
            out = rec.output()
            if rc == 0:
                rec.stats = _last_json_line(out)
            else:
                ctl = self._control()
                wid = _wid(rec, ctl.status())
                if wid is not None:
                    requeued = ctl.evict(wid)
                    self.log_fn(f"[pool] worker {i} died rc={rc}; evicted "
                                f"server id {wid}, {requeued} leases "
                                f"re-queued")
                else:
                    self.log_fn(f"[pool] worker {i} died rc={rc} before "
                                f"registering; nothing to evict")
                if out:
                    self.log_fn(f"[pool] worker {i} output:\n{out}")

    def join(self, *, timeout: float = 600.0, poll_s: float = 0.2) -> dict:
        """Supervise until the server reports the schedule drained (or
        every worker exited).  Returns the final server status."""
        t0 = time.time()
        ctl = self._control()
        while True:
            self.reap()
            st = ctl.status()
            leases = st.get("leases")
            if leases is not None and leases["done"] >= leases["total"]:
                break
            if self.alive() == 0:
                if leases is None or leases["done"] >= leases["total"]:
                    break
                raise RuntimeError(
                    f"all workers exited with {leases['total'] - leases['done']}"
                    f" visits unfinished: {leases}")
            if time.time() - t0 > timeout:
                raise TimeoutError(f"pool did not drain in {timeout}s: {st}")
            time.sleep(poll_s)
        # let clean exits finish and collect their stats lines
        for rec in self.procs:
            if rec.proc.poll() is None:
                try:
                    rec.proc.wait(timeout=_WAIT_S)
                except subprocess.TimeoutExpired:
                    rec.proc.kill()
                    rec.proc.wait(timeout=_WAIT_S)
        self.reap()
        return ctl.status()

    def stats(self) -> List[Optional[dict]]:
        return [p.stats for p in self.procs]

    def close(self) -> None:
        for rec in self.procs:
            if rec.proc.poll() is None:
                rec.proc.kill()
                rec.proc.wait(timeout=_WAIT_S)
        if self._ctl is not None:
            self._ctl.close()
            self._ctl = None

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.close()


def _wid(rec: _Proc, status: dict) -> Optional[int]:
    """Server-side worker id of a dead subprocess, resolved by its unique
    pool-assigned name in the server's registry (registration order is
    not a usable key -- control clients interleave)."""
    for wid, info in status.get("per_worker", {}).items():
        if info.get("role") == "worker" and info.get("name") == rec.cfg.name:
            return int(wid)
    return None


def _last_json_line(text: str) -> Optional[dict]:
    for line in reversed(text.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None
