"""The port's network parameter server (``repro_torch.ps.net``,
``repro_torch.data.leases``) against the JAX package's ``repro.ps.net``.

Laws pinned here:

  * **Wire**: every frame the port encodes is byte-identical to the
    reference's, for every op; payload codecs and constants agree.
  * **Lease book**: under the same operation sequence both packages' books
    give the same answers and states, in all three assignment modes.
  * **Interop**: the port's ``NetClient`` drives the JAX ``PSServer`` and
    the JAX ``NetClient`` drives the port's, op for op; mixed JAX and port
    workers against one server conserve counts.
  * **Exactly-once**: injected drops and closes force retries; the dedup
    cache answers replays, and the tables equal the apply-once oracle.
  * **Determinism**: one port worker (threaded, on the CPU) equals the
    port's ``_StreamPlane`` and the JAX ``run_worker`` bitwise, counts and
    every z file; two port workers conserve counts.
  * **The drill**: ``launch.net_smoke --device cpu`` passes (the one test
    here that spawns processes: a ``ps_server`` and two workers).
"""
import dataclasses
import json
import shutil
import socket
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import session as jsession
from repro.core import lightlda as jlda
from repro.data import leases as jleases
from repro.ps import client as jclient
from repro.ps import net as jnet
from repro.ps.net import wire as jwire
from repro.ps.net import worker as jworker
from repro_torch.api import session as tsession
from repro_torch.core import lightlda as tlda
from repro_torch.data import leases as tleases
from repro_torch.data import stream as tstream
from repro_torch.ps import client as tclient
from repro_torch.ps import net as tnet
from repro_torch.ps import routes as troutes
from repro_torch.ps.net import wire as twire
from repro_torch.ps.net import worker as tworker
from repro_torch.train import async_exec as texec

V, K = 40, 6
PKG = {"jax": jnet, "torch": tnet}


# ---------------------------------------------------------------------------
# wire: byte-identical frames
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(0)
    dense = rng.integers(-5, 6, (7, K)).astype(np.int32)
    coo = [rng.integers(0, V, 9).astype(np.int32) for _ in range(3)]
    return {
        twire.OP_HELLO: json.dumps({"name": "w", "nonce": "ab"}).encode(),
        twire.OP_PULL_BLOCK: twire.RANGE.pack(3, 5),
        twire.OP_PULL_FULL: b"",
        twire.OP_PUSH_DENSE: twire.DENSE.pack(0, K) + twire.a2b(dense),
        twire.OP_PUSH_COO: twire.COO.pack(9) + b"".join(map(twire.a2b, coo)),
        twire.OP_BARRIER: twire.BARRIER_HDR.pack(2) + b"e0",
        twire.OP_ACQUIRE: b"", twire.OP_RELEASE: twire.RELEASE_HDR.pack(7),
        twire.OP_COMMIT: twire.COMMIT_HDR.pack(3, 7, K, 9)
        + twire.a2b(dense) + b"".join(map(twire.a2b, coo))
        + twire.a2b(np.arange(K)) + twire.a2b(np.arange(20)),
        twire.OP_EVICT: twire.EVICT_HDR.pack(4), twire.OP_STATUS: b"",
        twire.OP_PLAN: json.dumps({"schedule": [[0, 0, 1]]}).encode(),
        twire.OP_SHUTDOWN: b"",
    }


@pytest.mark.parametrize("op", sorted(twire.OP_NAMES))
def test_request_frames_byte_identical(op):
    payload = _payloads()[op]
    for mat in (twire.MAT_NWK, twire.MAT_NK):
        for worker, seq in ((-1, 1), (3, 2 ** 40 + 5)):
            assert (twire.encode_request(op, mat, worker, seq, payload)
                    == jwire.encode_request(op, mat, worker, seq, payload))


def test_response_frames_codecs_and_constants_identical():
    for st in (twire.ST_OK, twire.ST_ERR, twire.ST_DUP):
        assert (twire.encode_response(st, 42, b"cached")
                == jwire.encode_response(st, 42, b"cached"))
    names = [n for n in dir(jwire) if n.isupper()]
    assert names == [n for n in dir(twire) if n.isupper()]
    for n in names:
        a, b = getattr(jwire, n), getattr(twire, n)
        if hasattr(a, "format"):            # struct.Struct
            assert a.format == b.format, n
        else:
            assert a == b, n
    arr = np.random.default_rng(1).integers(-2 ** 31, 2 ** 31 - 1, (17, 5),
                                            dtype=np.int32)
    assert twire.a2b(arr) == jwire.a2b(arr)
    back = twire.b2a(jwire.a2b(arr), arr.shape)
    np.testing.assert_array_equal(back, arr)
    assert back.flags.writeable


def test_recv_frame_reads_what_the_reference_sends():
    a, b = socket.socketpair()
    try:
        frame = jwire.encode_request(twire.OP_PUSH_DENSE, 0, 1, 9,
                                     b"\x01" * 70000)
        t = threading.Thread(target=jwire.send_frame, args=(a, frame))
        t.start()
        body = twire.recv_frame(b)
        t.join(timeout=10)
        assert body == frame[4:]
        a.close()
        with pytest.raises(ConnectionError):
            twire.recv_exact(b, 1)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# lease book: identical traces
# ---------------------------------------------------------------------------

def _trace(mod, mode, seed):
    rng = np.random.default_rng(seed)
    sched = [(e, p, int(s)) for e in range(3)
             for p, s in enumerate(rng.permutation(5))]
    book = mod.ShardLeaseBook(sched, mode=mode,
                              slots=0 if mode == "dynamic" else 3)
    out, held = [], []
    for _ in range(120):
        op = rng.integers(0, 6)
        w = int(rng.integers(0, 3))
        if op <= 2:
            st, lease = book.acquire(w, slot=w)
            out.append((st, None if lease is None else tuple(lease)))
            if lease is not None:
                held.append(lease.lease_id)
        elif op == 3 and held:
            out.append(book.complete(held.pop(int(rng.integers(0,
                                                               len(held))))))
        elif op == 4 and held:
            book.release(held.pop(0))
        elif op == 5:
            out.append(book.release_worker(w))
            if mode != "dynamic" and rng.random() < 0.3:
                out.append(book.orphan_slot(w))
        out.append((book.stats(), book.slot_backlog(), book.done,
                    book.active, book.all_done()))
    return out


@pytest.mark.parametrize("mode", ["dynamic", "static", "static_steal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lease_book_traces_equal_the_reference(mode, seed):
    assert _trace(tleases, mode, seed) == _trace(jleases, mode, seed)


def test_lease_book_validation_messages_equal():
    for kw in (dict(mode="nope"), dict(mode="static", slots=0)):
        with pytest.raises(ValueError) as te:
            tleases.ShardLeaseBook([(0, 0, 0)], **kw)
        with pytest.raises(ValueError) as je:
            jleases.ShardLeaseBook([(0, 0, 0)], **kw)
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# TableStore
# ---------------------------------------------------------------------------

def test_table_store_equals_reference_and_oracle():
    rng = np.random.default_rng(1)
    stores = [tnet.TableStore(V, K), jnet.TableStore(V, K)]
    oracle = np.zeros((V, K), np.int32)
    for _ in range(5):
        dense = rng.integers(-3, 4, (8, K)).astype(np.int32)
        rows = rng.integers(-2, V + 2, 50).astype(np.int32)
        cols = rng.integers(0, K, 50).astype(np.int32)
        vals = rng.choice([-1, 1], 50).astype(np.int32)
        for s in stores:
            s.apply_dense(twire.MAT_NWK, 4, dense)
            s.apply_coo(twire.MAT_NWK, rows, cols, vals)
            s.apply_coo(twire.MAT_NK, rows, cols, vals)
        oracle[4:12] += dense
        ok = (rows >= 0) & (rows < V)
        np.add.at(oracle, (rows[ok], cols[ok]), vals[ok])
    np.testing.assert_array_equal(stores[0].nwk, oracle)
    np.testing.assert_array_equal(stores[0].nwk, stores[1].nwk)
    np.testing.assert_array_equal(stores[0].nk, stores[1].nk)
    np.testing.assert_array_equal(stores[0].pull(twire.MAT_NWK, 3, 4),
                                  oracle[3:7])
    with pytest.raises(ValueError, match="out of bounds"):
        stores[0].pull(twire.MAT_NWK, V - 1, 2)
    with pytest.raises(ValueError, match="unknown matrix"):
        stores[0].mat(9)


# ---------------------------------------------------------------------------
# loopback, both directions
# ---------------------------------------------------------------------------

@pytest.fixture(params=[("torch", "jax"), ("jax", "torch"),
                        ("torch", "torch")],
                ids=["port-client-jax-server", "jax-client-port-server",
                     "port-both"])
def pair(request):
    cpkg, spkg = (PKG[p] for p in request.param)
    srv = spkg.PSServer(V, K).start()
    c = cpkg.NetClient.connect(srv.address, name="t")
    yield cpkg, srv, c
    c.close()
    srv.stop()


def test_loopback_ops(pair):
    cpkg, srv, c = pair
    dense = np.arange(V * K, dtype=np.int32).reshape(V, K)
    assert c.push_dense_prefix(twire.MAT_NWK, dense)
    np.testing.assert_array_equal(c.pull_full(twire.MAT_NWK), dense)
    np.testing.assert_array_equal(c.pull_block(twire.MAT_NWK, 3, 4),
                                  dense[3:7])
    assert c.push_coo(twire.MAT_NWK, np.array([0, 1], np.int32),
                      np.array([2, 3], np.int32), np.array([5, -1], np.int32))
    dense[0, 2] += 5
    dense[1, 3] -= 1
    np.testing.assert_array_equal(c.pull_full(twire.MAT_NWK), dense)
    nk = np.arange(K, dtype=np.int32)
    c.push_dense_prefix(twire.MAT_NK, nk)
    np.testing.assert_array_equal(c.pull_full(twire.MAT_NK), nk)
    with pytest.raises(cpkg.ServerError, match="out of bounds"):
        c.pull_block(twire.MAT_NWK, V - 1, 5)
    # a replayed mutating op is answered from the cache, not re-applied
    seq = c.t.next_seq()
    payload = twire.DENSE.pack(0, 0) + twire.a2b(np.ones(K, np.int32))
    st = [c.t.request(twire.OP_PUSH_DENSE, twire.MAT_NK, payload,
                      seq=seq)[0] for _ in range(2)]
    assert st == [twire.ST_OK, twire.ST_DUP]
    np.testing.assert_array_equal(c.pull_full(twire.MAT_NK), nk + 1)
    assert srv.dup_acks == 1
    # leases: plan, acquire (replayed: one grant), commit, status
    c.plan([(0, 0, 0), (0, 1, 1)], expected_workers=0)
    seq = c.t.next_seq()
    r = [json.loads(c.t.request(twire.OP_ACQUIRE, seq=seq)[1])
         for _ in range(2)]
    assert r[0] == r[1] and r[0]["status"] == "lease"
    before = c.pull_full(twire.MAT_NK)
    assert c.commit(r[0]["lease_id"], np.zeros((0, K), np.int32),
                    (np.zeros(0, np.int32),) * 3,
                    np.eye(K, dtype=np.int32)[0], np.zeros(4, np.int32))
    assert c.pull_full(twire.MAT_NK)[0] == before[0] + 1
    st = c.status()
    assert st["leases"]["done"] == 1 and st["leases"]["active"] == 0
    assert st["dup_acks"] == 2


def test_hello_nonce_idempotent_across_packages(pair):
    _, _, c = pair
    body = json.dumps({"name": "x", "role": "worker",
                       "nonce": "deadbeef"}).encode()
    w = [json.loads(c.t.request(twire.OP_HELLO, payload=body)[1])["worker"]
         for _ in range(2)]
    assert w[0] == w[1]


@pytest.mark.parametrize("action", [tnet.FaultInjector.DROP,
                                    tnet.FaultInjector.CLOSE_BEFORE,
                                    tnet.FaultInjector.CLOSE_AFTER])
def test_fault_injection_is_exactly_once(action):
    srv = tnet.PSServer(V, K).start()
    try:
        fault = tnet.FaultInjector.once_per_op(action)
        c = tnet.NetClient.connect(srv.address, name="faulty", fault=fault)
        dense = np.full((V, K), 2, np.int32)
        c.push_dense_prefix(twire.MAT_NWK, dense)
        rows = np.array([0, 1, 2], np.int32)
        vals = np.array([1, -1, 1], np.int32)
        c.push_coo(twire.MAT_NWK, rows, rows, vals)
        c.barrier("fault-e0", 1)
        got = c.pull_full(twire.MAT_NWK)
        np.add.at(dense, (rows, rows), vals)
        np.testing.assert_array_equal(got, dense)
        for op in ("hello", "push_dense_prefix", "push_coo", "barrier",
                   "pull_full"):
            assert fault.fired.get(op) == 1, fault.fired
        assert c.t.retries >= 5
        if action == tnet.FaultInjector.CLOSE_AFTER:
            assert srv.dup_acks >= 3
        c.close()
        dead = tnet.NetClient(tnet.Transport(
            srv.address, tnet.TransportConfig(retries=2, backoff_base=0.001),
            fault=tnet.FaultInjector(lambda op, a: tnet.FaultInjector.DROP)))
        with pytest.raises(tnet.TransportError, match="after 3 attempts"):
            dead.t.request(twire.OP_STATUS)
    finally:
        srv.stop()


def test_fault_spec_and_worker_config_from_the_reference():
    assert tnet.FaultInjector.from_spec("") is None
    f = tnet.FaultInjector.from_spec("once_per_op:drop")
    assert f("acquire", 0) == "drop" and f("acquire", 0) is None
    with pytest.raises(ValueError, match="unknown fault spec"):
        tnet.FaultInjector.from_spec("sometimes")
    jcfg = jworker.WorkerConfig(server="h:1", stream_dir="/s", num_topics=9,
                                hot_words=5, fault="once_per_op")
    tcfg = tworker.WorkerConfig.from_json(jcfg.to_json())
    assert tcfg.device is None
    for name, value in json.loads(jcfg.to_json()).items():
        assert getattr(tcfg, name) == value, name


def test_commit_deltas_equal_the_reference():
    rng = np.random.default_rng(2)
    n, vocab = 500, 60
    w = rng.integers(0, vocab, n).astype(np.int32)
    zo = rng.integers(0, K, n).astype(np.int32)
    zn = np.where(rng.random(n) < 0.4, rng.integers(0, K, n), zo
                  ).astype(np.int32)
    changed = (zn != zo) & (np.arange(n) < 450)
    for hot in (0, 16, vocab):
        t = tworker._commit_deltas(w, zo, zn, changed, vocab, K, hot)
        j = jworker._commit_deltas(w, zo, zn, changed, vocab, K, hot)
        for a, b in zip((t[0], *t[1], t[2]), (j[0], *j[1], j[2])):
            np.testing.assert_array_equal(a, b)


def test_net_handles_push_like_the_in_process_handle():
    """The net handle ships a route's plan as the wire's two push ops; the
    server's table equals the in-process handle's push bitwise."""
    srv = tnet.PSServer(V, K).start()
    try:
        c = tnet.NetClient.connect(srv.address, name="h")
        rng = np.random.default_rng(3)
        base = torch.from_numpy(rng.integers(0, 9, (V, K)).astype(np.int32))
        c.push_dense_prefix(twire.MAT_NWK, base.numpy())
        local = tclient.PSClient.create().matrix_from_dense(base)
        rows = torch.from_numpy(rng.integers(0, V, 64).astype(np.int32))
        re = troutes.Reassign(rows, rows, *(torch.from_numpy(x) for x in (
            rng.integers(0, K, 64).astype(np.int32),
            rng.integers(0, K, 64).astype(np.int32),
            rng.random(64) < 0.7)))
        for route in (troutes.DenseRoute(), troutes.CooRoute(),
                      troutes.HybridRoute(hot_words=8)):
            h = tnet.NetMatrixHandle(c, V, K, route=route, device="cpu")
            h.push(re)
            local = dataclasses.replace(local, route=route).push(re)
            assert torch.equal(h.to_dense(), local.to_dense())
            assert h.pull_block(1, 16).result().shape == (16, K)
        vec = tnet.NetVectorHandle(c, K, device="cpu")
        vec.push(torch.tensor([1, 1, 3]), torch.tensor([2, 5, -1]))
        want = np.zeros(K, np.int32)
        np.add.at(want, [1, 1, 3], [2, 5, -1])
        np.testing.assert_array_equal(vec.value.numpy(), want)
        b = tclient.PSClient.create(backend="net", server=srv.address)
        assert isinstance(b.backend, tnet.NetBackend)
        assert b.backend.net.meta["vocab"] == V
        b.backend.net.close()
        c.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# workers: bitwise against the stream plane and the JAX worker
# ---------------------------------------------------------------------------

def _cfgs(vocab):
    kw = dict(num_topics=K, vocab_size=vocab, block_tokens=512,
              num_shards=1)
    return jlda.LDAConfig(**kw), tlda.LDAConfig(**kw)


def _serve(pkg, path, vocab, epochs, expected):
    """A server on ``path`` seeded the way the session seeds it, with the
    visit plan installed; returns ``(server, control client)``."""
    jcfg, tcfg = _cfgs(vocab)
    if pkg is jnet:
        reader = jsession.stream_mod.ShardedCorpusReader(path)
        nwk, nk = jsession.init_stream(reader, jcfg, 0,
                                       client=jclient.PSClient.create())
        nwk, nk = np.asarray(nwk.to_dense()), np.asarray(nk.value)
    else:
        reader = tstream.ShardedCorpusReader(path)
        nwk, nk = tsession.init_stream(reader, tcfg, 0,
                                       client=tclient.PSClient.create(),
                                       device="cpu")
        nwk, nk = nwk.to_dense().numpy(), nk.value.numpy()
    srv = pkg.PSServer(vocab, K, stream_dir=path).start()
    ctl = tnet.NetClient.connect(srv.address, name="ctl", role="ctl")
    ctl.push_dense_prefix(twire.MAT_NWK, nwk)
    ctl.push_dense_prefix(twire.MAT_NK, nk)
    loader = tstream.StreamingLoader(reader, seed=0, prefetch=False)
    ctl.plan(loader.schedule(tstream.Cursor(0, 0), epochs),
             expected_workers=expected)
    return srv, ctl


def _threads(fns, timeout=300):
    out = [None] * len(fns)

    def go(i):
        out[i] = fns[i]()

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(fns))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts)
    assert all(r is not None for r in out), out
    return out


def _port_worker(srv, path, **kw):
    return lambda: tworker.run_worker(tworker.WorkerConfig(
        server=srv.address, stream_dir=path, num_topics=K, block_tokens=512,
        seed=0, warmup=False, device="cpu", **kw))


def _jax_worker(srv, path, **kw):
    return lambda: jworker.run_worker(jworker.WorkerConfig(
        server=srv.address, stream_dir=path, num_topics=K, block_tokens=512,
        seed=0, warmup=False, **kw))


def _z_files(path):
    r = tstream.ShardedCorpusReader(path)
    return [r.read_z(s) for s in range(r.num_shards)]


def test_one_port_worker_equals_stream_plane_and_jax_worker(stream_dir,
                                                            tmp_path):
    path, _, corp = stream_dir
    dirs = {n: str(tmp_path / n) for n in ("plane", "port", "jax")}
    for d in dirs.values():
        shutil.copytree(path, d)
    _, tcfg = _cfgs(corp.vocab_size)
    plane = tsession._StreamPlane(dirs["plane"], tcfg, texec.ExecConfig(),
                                  2, seed=0, prefetch=False, device="cpu",
                                  log_fn=lambda *a: None)
    plane.setup()
    for visit in plane.schedule():
        plane.step(visit)
    tables = {}
    for name, pkg, worker in (("port", tnet, _port_worker),
                              ("jax", jnet, _jax_worker)):
        srv, ctl = _serve(pkg, dirs[name], corp.vocab_size, 2, 1)
        try:
            (stats,) = _threads([worker(srv, dirs[name])])
            assert stats["superseded"] == 0 and stats["visits"] == 10
            tables[name] = (ctl.pull_full(twire.MAT_NWK),
                            ctl.pull_full(twire.MAT_NK))
            ctl.close()
        finally:
            srv.stop()
    want = (plane.nwk.to_dense().numpy(), plane.nk.value.numpy())
    for name in ("port", "jax"):
        for a, b in zip(tables[name], want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    zs = {n: _z_files(d) for n, d in dirs.items()}
    for s, z in enumerate(zs["plane"]):
        np.testing.assert_array_equal(zs["port"][s], z, err_msg=f"shard {s}")
        np.testing.assert_array_equal(zs["jax"][s], z, err_msg=f"shard {s}")


@pytest.mark.parametrize("mixed", [False, True], ids=["port+port",
                                                      "jax+port"])
def test_two_workers_conserve_counts(stream_dir, mixed):
    """Two threaded workers against one port server -- two port workers,
    or one JAX and one port worker -- conserve counts exactly: the server
    tables equal the histogram of the on-disk assignments."""
    path, reader, corp = stream_dir
    srv, ctl = _serve(tnet, path, corp.vocab_size, 2, 2)
    try:
        first = _jax_worker if mixed else _port_worker
        stats = _threads([first(srv, path, name="a", commit_hot_rows=16),
                          _port_worker(srv, path, name="b",
                                       commit_hot_rows=16)])
        nwk = ctl.pull_full(twire.MAT_NWK)
        nk = ctl.pull_full(twire.MAT_NK)
        rw, rk = tstream.rebuild_counts_from_stream(
            tstream.ShardedCorpusReader(path), K)
        np.testing.assert_array_equal(nwk, rw)
        np.testing.assert_array_equal(nk, rk)
        assert int(nk.sum()) == corp.w.shape[0]
        st = ctl.status()
        assert st["leases"]["done"] == st["leases"]["total"] == 10
        assert sum(s["visits"] for s in stats) == 10
        port = stats[1]
        assert port["device"] == "cpu"
        assert (port["tokens"] > 0) == (port["visits"] > 0)
        assert set(port["visit_ms"]) == set(tworker.VISIT_PARTS)
        if not mixed:
            assert sum(s["tokens"] for s in stats) == 2 * corp.w.shape[0]
        assert st["commit_ms_median"] > 0
        ctl.close()
    finally:
        srv.stop()


def test_net_smoke_drill_on_the_cpu():
    """``launch.net_smoke``: a ps_server subprocess, two worker
    subprocesses under injected faults, one SIGKILLed mid-epoch; exact
    conservation and the perplexity within tolerance."""
    from repro_torch.launch import net_smoke
    out = net_smoke.run_smoke(workers=2, device="cpu", log=lambda *a: None)
    assert out["device"] == "cpu" and out["dup_acks"] >= 1
    assert out["rel_diff"] < 0.2
