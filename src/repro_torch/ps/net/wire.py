"""Wire format of the network parameter server (DESIGN.md section 15).

Length-prefixed binary frames over TCP.  Every frame is

    <u32 little-endian body length> <body>

and a request body is

    <u8 op> <u8 matrix id> <i32 worker id> <i64 seq> <op payload>

with numpy buffers shipped raw as little-endian ``int32`` -- the same
bytes ``DistributedMatrix`` stores, so a pull/push round trip is
bit-exact.  A response body is ``<u8 status> <i64 seq echo> <payload>``.

Sequence numbers are the exactly-once contract: each client transport
stamps every request from one per-worker monotone counter and *reuses*
the stamp across retries, so the server can deduplicate a replayed
mutating op (``MUTATING``) and answer it from its per-worker response
cache instead of applying it twice.  Pulls are naturally idempotent and
skip the cache.

Matrix ids: ``MAT_NWK`` (0) is the ``[V, K]`` topic-word table,
``MAT_NK`` (1) the ``[K]`` topic-total vector (1-D payloads are flagged
by ``ncols == 0`` in the shape headers).
"""
from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

import numpy as np

# -- framing ----------------------------------------------------------------
_LEN = struct.Struct("<I")
REQ = struct.Struct("<BBiq")            # op, mat, worker, seq
RESP = struct.Struct("<Bq")             # status, seq echo

MAX_FRAME = 1 << 30                     # sanity bound on one frame's body

# -- op codes ---------------------------------------------------------------
OP_HELLO = 1
OP_PULL_BLOCK = 2
OP_PULL_FULL = 3
OP_PUSH_DENSE = 4                       # push_dense_prefix: start + rows
OP_PUSH_COO = 5
OP_BARRIER = 6
OP_ACQUIRE = 7
OP_COMMIT = 8
OP_RELEASE = 9
OP_EVICT = 10
OP_STATUS = 11
OP_PLAN = 12
OP_SHUTDOWN = 13

OP_NAMES = {
    OP_HELLO: "hello", OP_PULL_BLOCK: "pull_block",
    OP_PULL_FULL: "pull_full", OP_PUSH_DENSE: "push_dense_prefix",
    OP_PUSH_COO: "push_coo", OP_BARRIER: "barrier",
    OP_ACQUIRE: "acquire", OP_COMMIT: "commit", OP_RELEASE: "release",
    OP_EVICT: "evict", OP_STATUS: "status", OP_PLAN: "plan",
    OP_SHUTDOWN: "shutdown",
}

# Ops whose effect must apply exactly once: deduplicated by (worker, seq)
# with the original response replayed to retries.  ACQUIRE is here because
# a lost lease grant must not hand out a *second* lease on retry.
MUTATING = frozenset({OP_PUSH_DENSE, OP_PUSH_COO, OP_BARRIER, OP_ACQUIRE,
                      OP_COMMIT, OP_RELEASE, OP_EVICT, OP_PLAN})

# -- response statuses ------------------------------------------------------
ST_OK = 0
ST_ERR = 1
ST_DUP = 2                              # ok; replayed from the dedup cache

# -- matrix ids -------------------------------------------------------------
MAT_NWK = 0
MAT_NK = 1

# -- op payload sub-headers -------------------------------------------------
RANGE = struct.Struct("<ii")            # pull_block: start, nrows
DENSE = struct.Struct("<ii")            # push_dense_prefix: start, ncols
COO = struct.Struct("<i")               # push_coo: n entries
BARRIER_HDR = struct.Struct("<i")       # barrier: expected count (+ token)
SHAPE = struct.Struct("<ii")            # pull_full resp: nrows, ncols
RELEASE_HDR = struct.Struct("<q")       # release: lease id
EVICT_HDR = struct.Struct("<i")         # evict: worker id
COMMIT_HDR = struct.Struct("<qiii")     # commit: lease, hot_rows, K, n_coo

I4 = np.dtype("<i4")


def a2b(arr) -> bytes:
    """Raw little-endian int32 bytes of an array (C-order)."""
    return np.ascontiguousarray(np.asarray(arr), dtype=I4).tobytes()


def b2a(buf: bytes, shape: Optional[Tuple[int, ...]] = None) -> np.ndarray:
    """Decode raw little-endian int32 bytes (writable copy)."""
    arr = np.frombuffer(buf, dtype=I4).copy()
    return arr.reshape(shape) if shape is not None else arr


def encode_request(op: int, mat: int, worker: int, seq: int,
                   payload: bytes = b"") -> bytes:
    body = REQ.pack(op, mat, worker, seq) + payload
    return _LEN.pack(len(body)) + body


def encode_response(status: int, seq: int, payload: bytes = b"") -> bytes:
    body = RESP.pack(status, seq) + payload
    return _LEN.pack(len(body)) + body


def send_frame(sock: socket.socket, frame: bytes) -> None:
    sock.sendall(frame)


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    """Read one length-prefixed frame body."""
    (n,) = _LEN.unpack(recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise ConnectionError(f"frame of {n} bytes exceeds MAX_FRAME")
    return recv_exact(sock, n)
