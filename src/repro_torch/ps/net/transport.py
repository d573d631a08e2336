"""Fault-tolerant client transport for the network parameter server.

``Transport`` owns a small connection pool to one server and one retry
loop: every request is stamped with a per-worker monotone sequence
number, and a transport failure (timeout, reset, EOF) closes the broken
socket, sleeps a bounded exponential backoff, redials and *replays the
same stamp* -- the server's dedup cache (``server.PSServer``) then makes
retried mutating ops exactly-once, which is the whole count-conservation
contract (DESIGN.md section 15).  Logical errors from the server
(``ST_ERR``) raise ``ServerError`` and are never retried.

``FaultInjector`` makes the retry path deterministic and testable: a
plan decides, per (op name, attempt), whether to drop the request before
sending, close the socket after sending (the response-lost case -- the
one that *requires* dedup), or delay.  ``FaultInjector.once_per_op()``
forces one retry for every op type a run uses.

Telemetry: every request records ``ps.rpc.<op>`` spans plus
``ps.rpc.bytes_out.<op>`` / ``ps.rpc.bytes_in.<op>`` / ``ps.rpc.calls.<op>``
counters, ``ps.rpc.retries`` / ``ps.rpc.reconnects`` totals and a
``ps.rpc.ms.<op>`` latency histogram -- what ``launch.obs_report`` (the
port's and the JAX package's) reads for its "network" section.

``NetClient`` is the typed op surface over the transport (numpy in/out);
``repro_torch.ps.net.backend`` builds ``Backend``/handle objects on top
of it.  This module is numpy and stdlib, as the reference's is; its
frames are byte-identical to the JAX package's, so either package's
client talks to either package's server.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.data.leases import Lease
from repro_torch.ps.net import wire


class TransportError(ConnectionError):
    """All retries exhausted (or the fault plan consumed them)."""


class ServerError(RuntimeError):
    """The server rejected the op (logical error; never retried)."""


class TransportConfig(NamedTuple):
    """Retry/timeout policy.  ``delay_ms`` adds a fixed per-request
    emulated network RTT (the latency-hiding benchmarks' knob --
    loopback TCP has none)."""
    timeout: float = 15.0
    retries: int = 6
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    pool: int = 2
    delay_ms: float = 0.0


class FaultInjector:
    """Deterministic frame-granularity fault plan.

    ``plan(op_name, attempt)`` returns one of ``None`` (no fault),
    ``"drop"`` (swallow the request: the server never sees it),
    ``"close_before_send"`` (connection dies first), ``"close_after_send"``
    (request applied, response lost -- the dedup-critical case) or
    ``"delay:<ms>"``.  Fired faults are counted in ``.fired``.
    """

    DROP = "drop"
    CLOSE_BEFORE = "close_before_send"
    CLOSE_AFTER = "close_after_send"

    def __init__(self, plan: Callable[[str, int], Optional[str]]):
        self.plan = plan
        self.fired: Dict[str, int] = {}

    def __call__(self, op_name: str, attempt: int) -> Optional[str]:
        action = self.plan(op_name, attempt)
        if action:
            self.fired[op_name] = self.fired.get(op_name, 0) + 1
        return action

    @classmethod
    def once_per_op(cls, action: str = "close_after_send",
                    ops: Optional[List[str]] = None) -> "FaultInjector":
        """Fault the *first* attempt of every (listed) op type once --
        guarantees >= 1 forced retry per op type a run exercises."""
        done: set = set()

        def plan(op_name: str, attempt: int) -> Optional[str]:
            if attempt == 0 and op_name not in done \
                    and (ops is None or op_name in ops):
                done.add(op_name)
                return action
            return None
        return cls(plan)

    @classmethod
    def from_spec(cls, spec: str) -> Optional["FaultInjector"]:
        """Parse the subprocess-worker env spec: ``""`` (none) or
        ``once_per_op[:action]``."""
        if not spec:
            return None
        parts = spec.split(":", 1)
        if parts[0] != "once_per_op":
            raise ValueError(f"unknown fault spec {spec!r}")
        return cls.once_per_op(parts[1] if len(parts) > 1 else
                               cls.CLOSE_AFTER)


class Transport:
    """Connection-pooled request/response channel to one ``PSServer``."""

    def __init__(self, address: str, config: TransportConfig = None,
                 fault: Optional[FaultInjector] = None):
        host, _, port = address.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.config = config or TransportConfig()
        self.fault = fault
        self.worker_id = -1
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._pool: List[socket.socket] = []
        self._pool_lock = threading.Lock()
        self.retries = 0
        self.reconnects = 0

    # -- sequencing ----------------------------------------------------------
    def next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    # -- pool ---------------------------------------------------------------
    def _dial(self) -> socket.socket:
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.config.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _checkout(self, fresh: bool) -> socket.socket:
        if not fresh:
            with self._pool_lock:
                if self._pool:
                    return self._pool.pop()
        return self._dial()

    def _checkin(self, conn: socket.socket) -> None:
        with self._pool_lock:
            if len(self._pool) < self.config.pool:
                self._pool.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._pool_lock:
            for conn in self._pool:
                try:
                    conn.close()
                except OSError:
                    pass
            self._pool.clear()

    # -- the retry loop ------------------------------------------------------
    def request(self, op: int, mat: int = 0, payload: bytes = b"",
                seq: Optional[int] = None) -> Tuple[int, bytes]:
        """Send one op, surviving transport faults; returns
        ``(status, response payload)`` with status ``ST_OK`` or ``ST_DUP``.
        ``seq`` defaults to a fresh stamp; retries reuse it."""
        cfg = self.config
        name = wire.OP_NAMES[op]
        if seq is None:
            seq = self.next_seq()
        frame = wire.encode_request(op, mat, self.worker_id, seq, payload)
        reg = _obs.metrics_registry()
        sp = _obs.span(f"ps.rpc.{name}", cat="net")
        if sp is not _obs.NULL_SPAN:
            sp.set(op=name, bytes_out=len(frame), seq=seq)
        t0 = time.perf_counter()
        last_err: Optional[BaseException] = None
        try:
            for attempt in range(cfg.retries + 1):
                if attempt:
                    self.retries += 1
                    if reg is not None:
                        reg.counter("ps.rpc.retries").inc()
                    time.sleep(min(cfg.backoff_base * (2 ** (attempt - 1)),
                                   cfg.backoff_max))
                action = self.fault(name, attempt) if self.fault else None
                if action == FaultInjector.DROP:
                    last_err = TransportError(f"{name}: injected drop")
                    continue
                if action and action.startswith("delay:"):
                    time.sleep(float(action.split(":", 1)[1]) / 1e3)
                    action = None
                if cfg.delay_ms:
                    time.sleep(cfg.delay_ms / 1e3)
                conn = None
                try:
                    conn = self._checkout(fresh=attempt > 0)
                    if attempt:
                        self.reconnects += 1
                        if reg is not None:
                            reg.counter("ps.rpc.reconnects").inc()
                    if action == FaultInjector.CLOSE_BEFORE:
                        conn.close()
                        raise ConnectionError(f"{name}: injected close "
                                              "before send")
                    wire.send_frame(conn, frame)
                    if action == FaultInjector.CLOSE_AFTER:
                        conn.close()
                        raise ConnectionError(f"{name}: injected close "
                                              "after send")
                    body = wire.recv_frame(conn)
                except (ConnectionError, socket.timeout, OSError) as e:
                    if conn is not None:
                        try:
                            conn.close()
                        except OSError:
                            pass
                    last_err = e
                    continue
                status, rseq = wire.RESP.unpack_from(body)
                resp = body[wire.RESP.size:]
                if rseq != seq:      # desynced socket: drop it, retry
                    conn.close()
                    last_err = TransportError(f"{name}: response for seq "
                                              f"{rseq}, wanted {seq}")
                    continue
                self._checkin(conn)
                if status == wire.ST_ERR:
                    raise ServerError(f"{name}: "
                                      f"{resp.decode('utf-8', 'replace')}")
                if reg is not None:
                    reg.counter(f"ps.rpc.calls.{name}").inc()
                    reg.counter(f"ps.rpc.bytes_out.{name}").inc(len(frame))
                    reg.counter(f"ps.rpc.bytes_in.{name}").inc(len(body))
                    reg.histogram(f"ps.rpc.ms.{name}").record(
                        (time.perf_counter() - t0) * 1e3)
                if sp is not _obs.NULL_SPAN:
                    sp.set(bytes_in=len(body), attempts=attempt + 1,
                           dup=status == wire.ST_DUP)
                return status, resp
            raise TransportError(
                f"{name} failed after {cfg.retries + 1} attempts to "
                f"{self.host}:{self.port}: {last_err}")
        finally:
            if sp is not _obs.NULL_SPAN:
                sp.end()


class NetClient:
    """Typed op surface over one ``Transport`` (numpy in, numpy out)."""

    def __init__(self, transport: Transport):
        self.t = transport
        self.meta: dict = {}

    @classmethod
    def connect(cls, address: str, *, name: str = "", role: str = "worker",
                config: TransportConfig = None,
                fault: Optional[FaultInjector] = None) -> "NetClient":
        c = cls(Transport(address, config=config, fault=fault))
        c.hello(name, role=role)
        return c

    def close(self) -> None:
        self.t.close()

    # -- registration --------------------------------------------------------
    def hello(self, name: str = "", role: str = "worker") -> dict:
        """Register with the server.  The one-shot nonce makes a retried
        hello (response lost in flight) idempotent: the server returns
        the already-assigned worker id instead of a ghost registration.
        ``role="ctl"`` marks a control/observer client that must not
        count toward the worker start gate."""
        import uuid
        _, resp = self.t.request(wire.OP_HELLO, payload=json.dumps(
            {"name": name, "role": role,
             "nonce": uuid.uuid4().hex}).encode("utf-8"))
        self.meta = json.loads(resp.decode("utf-8"))
        self.t.worker_id = self.meta["worker"]
        return self.meta

    # -- pulls ---------------------------------------------------------------
    def pull_block(self, mat: int, start: int, nrows: int) -> np.ndarray:
        _, resp = self.t.request(wire.OP_PULL_BLOCK, mat,
                                 wire.RANGE.pack(start, nrows))
        if mat == wire.MAT_NK:
            return wire.b2a(resp)
        return wire.b2a(resp, (nrows, self.meta["topics"]))

    def pull_full(self, mat: int) -> np.ndarray:
        _, resp = self.t.request(wire.OP_PULL_FULL, mat)
        nrows, ncols = wire.SHAPE.unpack_from(resp)
        raw = resp[wire.SHAPE.size:]
        return wire.b2a(raw) if ncols == 0 else wire.b2a(raw, (nrows, ncols))

    # -- pushes (exactly-once via seq dedup) ---------------------------------
    def push_dense_prefix(self, mat: int, delta: np.ndarray,
                          start: int = 0) -> bool:
        """Additive dense delta to rows [start, start+len) (start=0: the
        hybrid route's hot-prefix wire shape).  True if applied, False
        if the server deduplicated a retry."""
        ncols = delta.shape[1] if delta.ndim == 2 else 0
        st, _ = self.t.request(wire.OP_PUSH_DENSE, mat,
                               wire.DENSE.pack(start, ncols)
                               + wire.a2b(delta))
        return st == wire.ST_OK

    def push_coo(self, mat: int, rows, cols, vals) -> bool:
        rows = np.asarray(rows, wire.I4).ravel()
        n = rows.shape[0]
        st, _ = self.t.request(
            wire.OP_PUSH_COO, mat,
            wire.COO.pack(n) + wire.a2b(rows) + wire.a2b(cols)
            + wire.a2b(vals))
        return st == wire.ST_OK

    # -- coordination --------------------------------------------------------
    def barrier(self, token: str, expected: int) -> None:
        self.t.request(wire.OP_BARRIER,
                       payload=wire.BARRIER_HDR.pack(expected)
                       + token.encode("utf-8"))

    def acquire(self) -> Tuple[str, Optional[Lease]]:
        _, resp = self.t.request(wire.OP_ACQUIRE)
        out = json.loads(resp.decode("utf-8"))
        if out["status"] != "lease":
            return out["status"], None
        return "lease", Lease(out["lease_id"], out["epoch"], out["pos"],
                              out["shard"])

    def commit(self, lease_id: int, hot_dense: np.ndarray, coo, nk_delta,
               z_new) -> bool:
        """Transactional shard commit (nwk hot-prefix + COO deltas, nk
        delta, new z).  True if applied; False if superseded/dup."""
        rows, cols, vals = coo
        rows = np.asarray(rows, wire.I4).ravel()
        k = int(nk_delta.shape[0])
        hot = np.asarray(hot_dense, wire.I4)
        if hot.ndim != 2:
            hot = hot.reshape(0, k)
        payload = (wire.COMMIT_HDR.pack(lease_id, hot.shape[0], k,
                                        rows.shape[0])
                   + wire.a2b(hot) + wire.a2b(rows) + wire.a2b(cols)
                   + wire.a2b(vals) + wire.a2b(nk_delta) + wire.a2b(z_new))
        _, resp = self.t.request(wire.OP_COMMIT, wire.MAT_NWK, payload)
        # a ST_DUP replay carries the *original* outcome: still applied
        return bool(json.loads(resp.decode("utf-8")).get("applied"))

    def release(self, lease_id: int) -> None:
        self.t.request(wire.OP_RELEASE,
                       payload=wire.RELEASE_HDR.pack(lease_id))

    def evict(self, worker: int) -> int:
        _, resp = self.t.request(wire.OP_EVICT,
                                 payload=wire.EVICT_HDR.pack(worker))
        return json.loads(resp.decode("utf-8"))["requeued"]

    def plan(self, schedule, *, mode: str = "dynamic", slots: int = 0,
             expected_workers: int = 0) -> None:
        """Install the visit schedule: ``(epoch, pos, shard)`` triples or
        ``StreamingLoader.schedule``'s ``(Cursor, shard)`` pairs."""
        visits = [[v[0].epoch, v[0].pos, v[1]] if len(v) == 2
                  else [int(v[0]), int(v[1]), int(v[2])] for v in schedule]
        self.t.request(wire.OP_PLAN, payload=json.dumps({
            "schedule": visits, "mode": mode, "slots": slots,
            "expected_workers": expected_workers}).encode("utf-8"))

    def status(self) -> dict:
        _, resp = self.t.request(wire.OP_STATUS)
        return json.loads(resp.decode("utf-8"))

    def shutdown(self) -> None:
        try:
            self.t.request(wire.OP_SHUTDOWN)
        except (TransportError, ConnectionError):
            pass
