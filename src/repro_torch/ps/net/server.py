"""The standalone parameter-server process (paper section 2, Glint's
server role; DESIGN.md section 15).

``PSServer`` hosts the authoritative ``[V, K]`` topic-word table and the
``[K]`` topic-total vector as host numpy arrays and serves the wire ops
(``repro_torch.ps.net.wire``) over TCP, one handler thread per connection.
All mutations happen under one lock, in plain integer adds -- the same
commutative arithmetic ``DistributedMatrix`` uses, so counts pushed by
any interleaving of workers land bit-exactly.

Exactly-once: every mutating op carries ``(worker, seq)``; the server
remembers, per worker, which seqs it has applied and the response it
sent, and answers a replayed seq from that cache (status ``ST_DUP``)
without re-applying.  This is what makes the client transport's retry
loop safe for non-idempotent pushes.

Shard leases: when configured with a visit schedule (``OP_PLAN``) and a
stream directory, the server also runs the elastic pool's lease book
(``repro_torch.data.leases``).  A worker's ``OP_COMMIT`` is the transactional
unit: the shard's count delta is applied *and* its new ``z`` file is
written under the same lock, so the conservation invariant -- PS counts
== histogram of the on-disk assignments -- holds at every commit
boundary, whatever dies in between.

The server is numpy and stdlib: the tables stay in host memory as int32,
and nothing here touches torch or a card.  It is the JAX package's
server, kept as the port's own copy, and serves either package's
workers.  It also times each applied commit (the apply and the z write,
under the lock): ``status`` reports the median as ``commit_ms_median``.
"""
from __future__ import annotations

import json
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data import stream as stream_mod
from repro_torch.data.leases import ShardLeaseBook
from repro_torch.ps.net import wire

_DEDUP_KEEP = 256       # replay-cache entries kept per worker


class TableStore:
    """The served count tables: nwk [V, K] + nk [K], host int32."""

    def __init__(self, vocab: int, topics: int):
        self.vocab = int(vocab)
        self.topics = int(topics)
        self.nwk = np.zeros((self.vocab, self.topics), wire.I4)
        self.nk = np.zeros((self.topics,), wire.I4)

    def mat(self, mat_id: int) -> np.ndarray:
        if mat_id == wire.MAT_NWK:
            return self.nwk
        if mat_id == wire.MAT_NK:
            return self.nk
        raise ValueError(f"unknown matrix id {mat_id}")

    def pull(self, mat_id: int, start: int, nrows: int) -> np.ndarray:
        m = self.mat(mat_id)
        if start < 0 or start + nrows > m.shape[0]:
            raise ValueError(f"row range [{start}, {start + nrows}) out of "
                             f"bounds for matrix {mat_id} ({m.shape[0]} rows)")
        return m[start:start + nrows]

    def apply_dense(self, mat_id: int, start: int,
                    delta: np.ndarray) -> None:
        m = self.mat(mat_id)
        if start < 0 or start + delta.shape[0] > m.shape[0]:
            raise ValueError(f"dense push [{start}, "
                             f"{start + delta.shape[0]}) out of bounds")
        m[start:start + delta.shape[0]] += delta

    def apply_coo(self, mat_id: int, rows: np.ndarray, cols: np.ndarray,
                  vals: np.ndarray) -> None:
        m = self.mat(mat_id)
        ok = (rows >= 0) & (rows < m.shape[0])  # value-0 padding is masked
        rows = np.where(ok, rows, 0)
        vals = np.where(ok, vals, 0)
        if m.ndim == 1:
            np.add.at(m, rows, vals)
        else:
            np.add.at(m, (rows, cols), vals)


class _WorkerRec:
    __slots__ = ("name", "role", "slot", "commits", "dups", "seen", "cache")

    def __init__(self, name: str, slot: int, role: str = "worker"):
        self.name = name
        self.role = role
        self.slot = slot
        self.commits = 0
        self.dups = 0
        self.seen: Dict[int, bytes] = {}    # seq -> response body
        self.cache: list = []               # seq insertion order, for pruning


class PSServer:
    """Threaded TCP parameter server.  ``start()`` binds (port 0 picks a
    free port, read back from ``.port``) and serves in the background;
    ``stop()`` shuts the listener and handler threads down."""

    def __init__(self, vocab: int, topics: int, *, host: str = "127.0.0.1",
                 port: int = 0, stream_dir: Optional[str] = None,
                 log_fn=None):
        self.store = TableStore(vocab, topics)
        self.host, self.port = host, int(port)
        self.stream_dir = stream_dir
        self._reader = (stream_mod.ShardedCorpusReader(stream_dir)
                        if stream_dir else None)
        self.log_fn = log_fn or (lambda *a: None)
        self._lock = threading.Lock()
        self._workers: Dict[int, _WorkerRec] = {}
        self._nonces: Dict[str, int] = {}
        self._next_worker = 0
        self._barriers: Dict[str, dict] = {}
        self._barrier_cv = threading.Condition(self._lock)
        self._leases: Optional[ShardLeaseBook] = None
        self._expected_workers = 0
        self.dup_acks = 0
        self.commit_ms: List[float] = []   # host ms of each applied commit
        self._sock: Optional[socket.socket] = None
        self._threads: list = []
        self._stopping = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "PSServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(64)
        self.port = s.getsockname()[1]
        self._sock = s
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="ps-accept")
        t.start()
        self._threads.append(t)
        self.log_fn(f"[ps_server] listening on {self.address}")
        return self

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        self._stopping.set()
        with self._barrier_cv:
            self._barrier_cv.notify_all()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None

    def __enter__(self) -> "PSServer":
        return self.start()

    def __exit__(self, et, ev, tb) -> None:
        self.stop()

    # -- accept/handler loops --------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True, name="ps-conn")
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stopping.is_set():
                try:
                    body = wire.recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                op, mat, worker, seq = wire.REQ.unpack_from(body)
                payload = body[wire.REQ.size:]
                try:
                    frame = self._dispatch(op, mat, worker, seq, payload)
                except Exception as e:          # logical error: report, keep conn
                    frame = wire.encode_response(
                        wire.ST_ERR, seq, str(e).encode("utf-8"))
                if op == wire.OP_SHUTDOWN:
                    try:
                        wire.send_frame(conn, frame)
                    except OSError:
                        pass
                    self.stop()
                    return
                wire.send_frame(conn, frame)
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- exactly-once dedup ------------------------------------------------------
    def _count_dup(self, worker: int) -> None:
        self.dup_acks += 1
        rec = self._workers.get(worker)
        if rec is not None:
            rec.dups += 1

    def _replay(self, worker: int, seq: int) -> Optional[bytes]:
        rec = self._workers.get(worker)
        if rec is None:
            return None
        return rec.seen.get(seq)

    def _remember(self, worker: int, seq: int, resp_payload: bytes) -> None:
        rec = self._workers.get(worker)
        if rec is None:
            return
        rec.seen[seq] = resp_payload
        rec.cache.append(seq)
        while len(rec.cache) > _DEDUP_KEEP:
            rec.seen.pop(rec.cache.pop(0), None)

    def _dispatch(self, op: int, mat: int, worker: int, seq: int,
                  payload: bytes) -> bytes:
        if op in wire.MUTATING:
            if op == wire.OP_BARRIER:
                # barrier arrival is idempotent per worker, so the replay
                # check and the (blocking) wait need not be atomic
                with self._lock:
                    cached = self._replay(worker, seq)
                if cached is not None:
                    self._count_dup(worker)
                    return wire.encode_response(wire.ST_DUP, seq, cached)
                out = self._op_barrier(worker, payload)
                with self._lock:
                    self._remember(worker, seq, out)
                return wire.encode_response(wire.ST_OK, seq, out)
            with self._lock:    # replay check + apply: one atomic step
                cached = self._replay(worker, seq)
                if cached is not None:
                    self._count_dup(worker)
                    return wire.encode_response(wire.ST_DUP, seq, cached)
                out = self._apply(op, mat, worker, payload)
                self._remember(worker, seq, out)
            return wire.encode_response(wire.ST_OK, seq, out)
        # idempotent reads
        with self._lock:
            if op == wire.OP_HELLO:
                return wire.encode_response(wire.ST_OK, seq,
                                            self._op_hello(payload))
            if op == wire.OP_PULL_BLOCK:
                start, nrows = wire.RANGE.unpack_from(payload)
                return wire.encode_response(
                    wire.ST_OK, seq, wire.a2b(self.store.pull(mat, start,
                                                              nrows)))
            if op == wire.OP_PULL_FULL:
                m = self.store.mat(mat)
                ncols = m.shape[1] if m.ndim == 2 else 0
                return wire.encode_response(
                    wire.ST_OK, seq,
                    wire.SHAPE.pack(m.shape[0], ncols) + wire.a2b(m))
            if op == wire.OP_STATUS:
                return wire.encode_response(wire.ST_OK, seq,
                                            self._op_status())
            if op == wire.OP_SHUTDOWN:
                return wire.encode_response(wire.ST_OK, seq, b"")
        raise ValueError(f"unknown op {op}")

    # -- mutating ops (caller holds the lock) ---------------------------------
    def _apply(self, op: int, mat: int, worker: int,
               payload: bytes) -> bytes:
        if op == wire.OP_PUSH_DENSE:
            start, ncols = wire.DENSE.unpack_from(payload)
            raw = payload[wire.DENSE.size:]
            delta = (wire.b2a(raw) if ncols == 0
                     else wire.b2a(raw, (-1, ncols)))
            self.store.apply_dense(mat, start, delta)
            return b""
        if op == wire.OP_PUSH_COO:
            (n,) = wire.COO.unpack_from(payload)
            off = wire.COO.size
            sz = 4 * n
            rows = wire.b2a(payload[off:off + sz])
            cols = wire.b2a(payload[off + sz:off + 2 * sz])
            vals = wire.b2a(payload[off + 2 * sz:off + 3 * sz])
            self.store.apply_coo(mat, rows, cols, vals)
            return b""
        if op == wire.OP_ACQUIRE:
            return self._op_acquire(worker)
        if op == wire.OP_COMMIT:
            return self._op_commit(worker, payload)
        if op == wire.OP_RELEASE:
            (lease_id,) = wire.RELEASE_HDR.unpack_from(payload)
            if self._leases is not None:
                self._leases.release(lease_id)
            return b""
        if op == wire.OP_EVICT:
            (victim,) = wire.EVICT_HDR.unpack_from(payload)
            return self._op_evict(victim)
        if op == wire.OP_PLAN:
            return self._op_plan(payload)
        raise ValueError(f"unknown mutating op {op}")

    def _op_hello(self, payload: bytes) -> bytes:
        """Register a worker.  The client sends ``{"name", "nonce"}``; a
        repeated nonce (a retried hello whose response was lost) returns
        the existing id instead of registering a ghost worker."""
        try:
            req = json.loads(payload.decode("utf-8")) if payload else {}
        except json.JSONDecodeError:
            req = {"name": payload.decode("utf-8", "replace")}
        name = req.get("name", "")
        role = req.get("role", "worker")
        nonce = req.get("nonce")
        wid = self._nonces.get(nonce) if nonce else None
        if wid is None:
            wid = self._next_worker
            self._next_worker += 1
            slot = sum(r.role == "worker" for r in self._workers.values())
            self._workers[wid] = _WorkerRec(name, slot=slot, role=role)
            if nonce:
                self._nonces[nonce] = wid
            self.log_fn(f"[ps_server] {role} {wid} ({name!r}) registered")
        return json.dumps({
            "worker": wid, "vocab": self.store.vocab,
            "topics": self.store.topics,
            "workers": len(self._workers)}).encode("utf-8")

    def _op_barrier(self, worker: int, payload: bytes) -> bytes:
        (expected,) = wire.BARRIER_HDR.unpack_from(payload)
        token = payload[wire.BARRIER_HDR.size:].decode("utf-8")
        with self._barrier_cv:
            b = self._barriers.setdefault(token, {"arrived": set(),
                                                  "done": False})
            b["arrived"].add(worker)        # re-arrival of a retry is a no-op
            if len(b["arrived"]) >= expected:
                b["done"] = True
                self._barrier_cv.notify_all()
            while not b["done"] and not self._stopping.is_set():
                self._barrier_cv.wait(timeout=0.5)
        return b""

    def _op_plan(self, payload: bytes) -> bytes:
        plan = json.loads(payload.decode("utf-8"))
        schedule = [tuple(v) for v in plan["schedule"]]
        mode = plan.get("mode", "dynamic")
        slots = int(plan.get("slots", 0))
        self._leases = ShardLeaseBook(schedule, mode=mode, slots=slots)
        self._expected_workers = int(plan.get("expected_workers", 0))
        self.log_fn(f"[ps_server] plan: {len(schedule)} visits, mode="
                    f"{mode}, expecting {self._expected_workers} workers")
        return b""

    def _op_acquire(self, worker: int) -> bytes:
        if self._leases is None:
            return json.dumps({"status": "wait"}).encode("utf-8")
        # hold the start gate until the expected pool has registered, so
        # tokens/s measurements start from a fully joined pool (control
        # clients don't count)
        joined = sum(r.role == "worker" for r in self._workers.values())
        if joined < self._expected_workers:
            return json.dumps({"status": "wait"}).encode("utf-8")
        rec = self._workers.get(worker)
        slot = rec.slot if rec is not None else worker
        st, lease = self._leases.acquire(worker, slot=slot)
        out = {"status": st}
        if lease is not None:
            out.update(lease_id=lease.lease_id, epoch=lease.epoch,
                       pos=lease.pos, shard=lease.shard_id)
        return json.dumps(out).encode("utf-8")

    def _op_commit(self, worker: int, payload: bytes) -> bytes:
        """Transactional shard commit: COO + hot-prefix count deltas, the
        nk delta, and the shard's new z, applied/written atomically."""
        lease_id, hot_rows, k, n_coo = wire.COMMIT_HDR.unpack_from(payload)
        off = wire.COMMIT_HDR.size
        sz_dense = 4 * hot_rows * k
        sz_coo = 4 * n_coo
        dense = wire.b2a(payload[off:off + sz_dense], (hot_rows, k))
        off += sz_dense
        rows = wire.b2a(payload[off:off + sz_coo]); off += sz_coo
        cols = wire.b2a(payload[off:off + sz_coo]); off += sz_coo
        vals = wire.b2a(payload[off:off + sz_coo]); off += sz_coo
        nk_delta = wire.b2a(payload[off:off + 4 * k]); off += 4 * k
        z_new = wire.b2a(payload[off:])
        if self._leases is None:
            raise ValueError("commit without a lease plan")
        lease = self._leases.visit(lease_id)
        if not self._leases.complete(lease_id):
            # superseded: the visit was re-queued (eviction) and completed
            # by another worker; applying again would double-count
            return json.dumps({"applied": False}).encode("utf-8")
        t0 = time.perf_counter()
        if hot_rows:
            self.store.apply_dense(wire.MAT_NWK, 0, dense)
        if n_coo:
            self.store.apply_coo(wire.MAT_NWK, rows, cols, vals)
        self.store.apply_dense(wire.MAT_NK, 0, nk_delta)
        if self._reader is not None:
            self._reader.write_z(lease["shard"], z_new)
        self.commit_ms.append((time.perf_counter() - t0) * 1e3)
        rec = self._workers.get(worker)
        if rec is not None:
            rec.commits += 1
        return json.dumps({"applied": True}).encode("utf-8")

    def _op_evict(self, victim: int) -> bytes:
        n = 0
        if self._leases is not None:
            n = self._leases.release_worker(victim)
            rec = self._workers.get(victim)
            if rec is not None and self._leases.mode != "dynamic":
                self._leases.orphan_slot(rec.slot)
        self.log_fn(f"[ps_server] evicted worker {victim} "
                    f"({n} leases re-queued)")
        return json.dumps({"requeued": n}).encode("utf-8")

    def _op_status(self) -> bytes:
        ms = sorted(self.commit_ms)
        out = {"workers": len(self._workers), "dup_acks": self.dup_acks,
               "counts_sum": int(self.store.nk.sum()),
               "commit_ms_median": ms[len(ms) // 2] if ms else None,
               "per_worker": {str(w): {"name": r.name, "role": r.role,
                                       "commits": r.commits, "dups": r.dups}
                              for w, r in self._workers.items()}}
        if self._leases is not None:
            out["leases"] = self._leases.stats()
        return json.dumps(out).encode("utf-8")
