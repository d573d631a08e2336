"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  A kernel has no CPU mode, so every test here skips on a host
without a card.  The file imports neither jax nor the JAX package, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import alias as talias
from repro_torch.core import lightlda as tlda
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a hand-written kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


def _weights(v, k, seed):
    """Random rows plus a uniform row, exact-1.0 entries beside one small
    and one large, a near-one-hot row and an all-zero row."""
    rng = np.random.default_rng(seed)
    w = (rng.random((v, k)) ** 2 + 1e-5).astype(np.float32)
    w[0] = 1.0
    w[1] = 1.0
    w[1, 0], w[1, 1 % k] = 0.5, 1.5
    w[2] = 1e-6
    w[2, k // 3] = 1e3
    w[3] = 0.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("v,k", [(64, 1), (64, 7), (64, 130), (64, 1000),
                                 (64, 2000), (61, 1000), (61, 2000)])
def test_alias_build_kernel_matches_plain(card, v, k):
    """Bitwise in prob and alias; K = 2000 takes the two-level row sum, and
    V = 61 is no multiple of the rows per block."""
    w = _weights(v, k, seed=k).to(card)
    w[4] = 1e-6
    w[4, 0] = 1.0
    before = ops.launch_counts()["alias_build"]
    got = ops.alias_build(w)
    want = ref.alias_build_ref(w)
    assert ops.launch_counts()["alias_build"] == before + 1
    assert torch.equal(got.prob, want.prob)
    assert torch.equal(got.alias, want.alias)


def _mh_args(card, k, t, s, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    rows, docs = 64, 8
    nwk = torch.randint(0, 30, (rows, k), generator=g, device=card).float()
    nk = nwk.sum(0)
    table = talias.build_alias_rows((nwk + 0.01) / (nk + rows * 0.01))

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=card,
                             dtype=torch.int32)

    w, d, z0 = ints(rows, (t,)), ints(docs, (t,)), ints(k, (t,))
    ndk = ints(5, (docs, k))
    rng = tlda.MHRandoms(torch.rand((s, t), generator=g, device=card),
                         torch.rand((s, t), generator=g, device=card),
                         ints(k, (s, t)),
                         torch.rand((s, t), generator=g, device=card))
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=rows, mh_steps=s)
    return (rng, z0, w, d, nwk, ndk, nk, table.prob, table.alias, cfg)


@pytest.mark.parametrize("t", [100, 4096, 8192])
@pytest.mark.parametrize("k", [7, 130, 1000])
@pytest.mark.parametrize("frozen", [True, False])
def test_mh_sample_kernel_matches_plain_bitwise(card, k, frozen, t):
    """T = 100 is fewer tokens than SMs; 8,192 is a training group."""
    args = _mh_args(card, k, t, 2, seed=k + t)
    got = ops.mh_sample(*args, frozen=frozen)
    want = ref.mh_sample_ref(*args, frozen=frozen)
    assert torch.equal(got, want)
    assert (got != args[1]).float().mean() > 0.5


@pytest.mark.parametrize("steps", [1, 3, 4, 5])
def test_mh_sample_kernel_step_counts(card, steps):
    """Every unrolled step count and the generic loop (5 steps): bitwise
    equal to the plain version."""
    args = _mh_args(card, 130, 4096, steps, seed=steps)
    for frozen in (True, False):
        got = ops.mh_sample(*args, frozen=frozen)
        assert torch.equal(got, ref.mh_sample_ref(*args, frozen=frozen))


def test_serving_on_card_matches_cpu(card):
    """A small TopicModel on the card: θ equals the CPU path's bitwise."""
    from repro_torch.api import TopicModel
    from repro_torch.infer import EngineConfig, FoldInConfig
    rng = np.random.default_rng(0)
    k, v = 12, 300
    nwk = rng.integers(0, 50, (v, k)).astype(np.int32)
    ecfg = EngineConfig(max_batch=4, foldin=FoldInConfig(num_sweeps=8,
                                                         burnin=3))
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=v)
    gpu = TopicModel(nwk, nwk.sum(0), cfg, ecfg=ecfg)
    docs = [rng.integers(0, v, n).astype(np.int32) for n in (5, 40, 17, 90)]
    theta = gpu.transform(docs)
    snap = gpu.snapshot.to("cpu")
    from repro_torch.infer import QueryEngine
    cpu = QueryEngine(snap, ecfg).infer(docs, list(range(len(docs))))
    np.testing.assert_array_equal(theta, np.stack([r.theta for r in cpu]))


def _draw_group(k, batch, seed):
    """A training group's draw inputs (numpy): documents of lengths 0, 1
    and more, document 0 empty, padded slots naming it."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 60, 400).astype(np.int32)
    lens[::7], lens[1::7] = 0, 1
    n = int(lens.sum())
    npad = -(-n // batch) * batch + batch
    d = np.zeros(npad, np.int32)
    d[:n] = np.repeat(np.arange(lens.size, dtype=np.int32), lens)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    z = rng.integers(0, k, npad).astype(np.int32)
    lo = max((n // batch) * batch - batch // 2, 0)
    return d[lo:lo + batch], z, start, lens


@pytest.mark.parametrize("k", [7, 130, 1000])
@pytest.mark.parametrize("batch,steps", [(100, 2), (8192, 2), (8192, 4)])
def test_mh_draws_train_kernel_matches_plain_bitwise(card, k, batch, steps):
    """One launch writes all four arrays, bitwise the plain composition."""
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=50, mh_steps=steps)
    args = [torch.from_numpy(x).to(card)
            for x in _draw_group(k, batch, seed=k + batch)]
    key = torch.tensor([0x9E3779B9, k], dtype=torch.int64, device=card)
    before = ops.launch_counts()["mh_draws_train"]
    got = ops.mh_draws_train(key, *args, batch, cfg)
    assert ops.launch_counts()["mh_draws_train"] == before + 1
    want = ref.mh_draws_train_ref(key, *args, batch, cfg)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("k,sweep", [(7, 0), (1000, 0), (1000, 29)])
def test_mh_draws_foldin_kernel_matches_plain_bitwise(card, k, sweep):
    """Serving's [32 x 1024] batch, empty and full rows included."""
    from repro_torch import rng as trng
    rng = np.random.default_rng(k)
    b, l = 32, 1024
    nd = rng.integers(0, l + 1, b).astype(np.int32)
    nd[:3] = (0, 1, l)
    z = torch.from_numpy(rng.integers(0, k, (b, l)).astype(np.int32)
                         ).to(card)
    nd = torch.from_numpy(nd).to(card)
    keys = trng.keys_from_seeds(range(b), card)
    cfg = tlda.LDAConfig(num_topics=k, vocab_size=50)
    before = ops.launch_counts()["mh_draws_foldin"]
    got = ops.mh_draws_foldin(keys, sweep, z, nd, cfg)
    assert ops.launch_counts()["mh_draws_foldin"] == before + 1
    want = ref.mh_draws_foldin_ref(keys, sweep, z, nd, cfg)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


def _delta_batch(card, rows, k, t, seed, frac):
    """Zipf-skewed rows (thousands of tokens on row 0), some past the
    matrix, ``changed`` at the given fraction."""
    g = torch.Generator(device=card).manual_seed(seed)
    u = torch.rand((t,), generator=g, device=card)
    r = torch.clamp(torch.floor(torch.exp(u * np.log(rows))).long() - 1, 0,
                    rows - 1)
    past = torch.rand((t,), generator=g, device=card) < 0.01
    r = torch.where(past, rows + 3, r).int()
    zo = torch.randint(0, k, (t,), generator=g, device=card,
                       dtype=torch.int32)
    zn = torch.randint(0, k, (t,), generator=g, device=card,
                       dtype=torch.int32)
    return r, zo, zn, torch.rand((t,), generator=g, device=card) < frac


@pytest.mark.parametrize("rows,k", [(300, 7), (2048, 130), (2000, 1000)])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_delta_push_kernel_matches_plain_bitwise(card, rows, k, frac):
    args = _delta_batch(card, rows, k, 32 * 1024, rows + k, frac)
    before = ops.launch_counts()["delta_push"]
    got = ops.delta_push(*args, rows, k)
    assert ops.launch_counts()["delta_push"] == before + 1
    assert torch.equal(got, ref.delta_push_ref(*args, rows, k))


@pytest.mark.parametrize("rows,k", [(300, 7), (2048, 130), (2000, 1000)])
def test_delta_apply_coo_kernel_matches_plain_bitwise(card, rows, k):
    g = torch.Generator(device=card).manual_seed(k)
    m = 64 * 1024
    r = torch.randint(-2, rows + 2, (m,), generator=g, device=card)
    c = torch.randint(-1, k + 1, (m,), generator=g, device=card)
    r[m // 2:] = r[: m // 2]                      # every coordinate twice
    v = torch.randint(-3, 4, (m,), generator=g, device=card)
    base = torch.randint(0, 9, (rows, k), generator=g, device=card,
                         dtype=torch.int32)
    before = ops.launch_counts()["delta_apply_coo"]
    got = ops.delta_apply_coo(r, c, v, rows, k, out=base.clone())
    assert ops.launch_counts()["delta_apply_coo"] == before + 1
    assert torch.equal(got, ref.delta_apply_coo_ref(r, c, v, rows, k,
                                                    out=base.clone()))


def _merge_batch(card, rows, docs, k, t, seed, frac):
    """A group's reassignments for the merge: Zipf-skewed rows, doc ids in
    runs (document order), 1 % of each past its table."""
    r, zo, zn, changed = _delta_batch(card, rows, k, t, seed, frac)
    g = torch.Generator(device=card).manual_seed(seed + 1)
    d = torch.sort(torch.randint(0, docs, (t,), generator=g,
                                 device=card)).values
    past = torch.rand((t,), generator=g, device=card) < 0.01
    return r, zo, zn, changed, torch.where(past, docs + 2, d).int()


def _merge_tables(card, rows, docs, k, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randint(0, 9, shape, generator=g, device=card,
                          dtype=torch.int32)
            for shape in ((rows, k), (docs, k), (k,))]


def _merge_both(card, rows, docs, k, batch, seed):
    """The merge by the kernel and by its plain version, each into its own
    copy of the same tables."""
    from repro_torch.kernels import delta_push
    r, zo, zn, changed, d = batch
    got = _merge_tables(card, rows, docs, k, seed)
    want = [x.clone() for x in got]
    delta_push.delta_push_cuda(r, zo, zn, changed, got[0], docs=d,
                               ndk_out=got[1], nk_out=got[2])
    ref.delta_push_ref(r, zo, zn, changed, rows, k, out=want[0], docs=d,
                       ndk_out=want[1], nk_out=want[2])
    return got, want


@pytest.mark.parametrize("rows,docs,k", [
    (300, 50, 7), (2048, 400, 130), (100_000, 8000, 1000),
    (12_500, 8000, 1000)])
@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_delta_push_merge_matches_plain_bitwise(card, rows, docs, k, frac):
    """The merge form (n_wk, n_dk and n_k in one launch) at chip_smoke's
    shapes: 4,099 tokens (a scalar tail after the 16-byte quads), and the
    same batch one token in (no 16-byte alignment, every token scalar)."""
    batch = _merge_batch(card, rows, docs, k, 4100, rows + k, frac)
    for part in ([x[:4099] for x in batch], [x[1:] for x in batch]):
        before = ops.launch_counts()["delta_push"]
        got, want = _merge_both(card, rows, docs, k, part, seed=k)
        assert ops.launch_counts()["delta_push"] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("past", [0, 4])
def test_delta_push_merge_at_the_nk_histogram_limit(card, past):
    """K at the largest n_k histogram that fits a block's shared memory
    (K int32, rounded up to 4): bitwise.  Just past it the launch fails
    and the wrapper raises, launching nothing."""
    optin = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    k = optin // 16 * 4 + past
    batch = _merge_batch(card, 5, 3, k, 2048, seed=past, frac=0.7)
    if past:
        before = ops.launch_counts()["delta_push"]
        with pytest.raises(RuntimeError, match="delta_push kernel launch"):
            _merge_both(card, 5, 3, k, batch, seed=past)
        assert ops.launch_counts()["delta_push"] == before
        return
    got, want = _merge_both(card, 5, 3, k, batch, seed=past)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_routed_push_launches_both_kernels(card):
    """A hybrid push through ``MatrixHandle.push`` launches the dense form
    of delta_push and delta_apply_coo once each, and its table equals the
    one-launch merge's."""
    from repro_torch import ps
    rows, k, hot = 3000, 64, 200
    r, zo, zn, changed = _delta_batch(card, rows, k, 8192, 5, 0.6)
    r = torch.clamp(r, 0, rows - 1)
    base = torch.randint(0, 9, (rows, k), device=card, dtype=torch.int32)
    handle = ps.PSClient.create(num_shards=2).matrix_from_dense(
        base, route=ps.HybridRoute(hot_words=hot))
    ops.reset_launch_counts()
    pushed = handle.push(ps.Reassign(r, r, zo, zn, changed)).to_dense()
    counts = ops.launch_counts()
    assert counts["delta_push"] == 1 and counts["delta_apply_coo"] == 1
    merged = ops.delta_push(r, zo, zn, changed, rows, k, out=base.clone())
    assert torch.equal(pushed, merged)


@pytest.mark.parametrize("extra", [{}, {"model_blocks": 4, "staleness": 1}])
def test_training_on_card_matches_cpu(card, extra):
    """A small job through APSLDA on the card and on the CPU: z and every
    count table equal bitwise, and the card ran the training kernels: one
    delta_push per group (the whole merge), no delta_apply_coo."""
    from repro_torch.api import APSLDA, HybridRoute, LDAJob
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(120, 900, true_topics=8, seed=2)
    job = LDAJob(corpus=corp, num_topics=24, block_tokens=1024, sweeps=2,
                 eval_every=0, route=HybridRoute(hot_words=60), **extra)
    ops.reset_launch_counts()
    est = APSLDA(job, log_fn=lambda m: None)
    gpu = est.fit()
    counts = ops.launch_counts()
    info = est.result_.info
    groups = info["n_blocks"] // info["group"] * job.sweeps
    assert counts["mh_sample"] == groups
    assert counts["delta_push"] == groups
    assert counts["delta_apply_coo"] == 0
    assert counts["alias_build"] > 0      # the executors' tables
    est = APSLDA(job, log_fn=lambda m: None, device="cpu")
    cpu = est.fit()
    np.testing.assert_array_equal(gpu.nwk, cpu.nwk)
    np.testing.assert_array_equal(gpu.nk, cpu.nk)


@pytest.mark.parametrize("extra", [{}, {"model_blocks": 4, "staleness": 1}])
def test_streamed_training_on_card_matches_cpu(card, tmp_path, extra):
    """A small streamed job (2 epochs over 4 shards) through APSLDA on the
    card and on the CPU, each on its own copy of the stream: the counts
    and every shard's z file equal bitwise; the card launched one
    mh_sample and one delta_push per group and no delta_apply_coo."""
    from repro_torch.api import APSLDA, HybridRoute, LDAJob
    from repro_torch.data import stream
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(120, 900, true_topics=8, seed=2)
    tokens = 2048                       # 7,197 tokens: 4 shards
    models, readers = {}, {}
    for dev in ("cuda", "cpu"):
        path = str(tmp_path / dev)
        stream.write_sharded(path, corp, tokens_per_shard=tokens)
        job = LDAJob(stream_dir=path, num_topics=24, block_tokens=1024,
                     epochs=2, eval_every=0, seed=4,
                     route=HybridRoute(hot_words=60), **extra)
        ops.reset_launch_counts()
        est = APSLDA(job, log_fn=lambda m: None, device=dev)
        models[dev] = est.fit()
        readers[dev] = est.result_.reader
        assert readers[dev].num_shards == 4
        if dev == "cuda":
            counts = ops.launch_counts()
            info = est.result_.info
            visits = 2 * readers[dev].num_shards
            groups = visits * (info["n_blocks"] // info["group"]
                               if extra else tokens // 1024)
            assert counts["mh_sample"] == groups
            assert counts["delta_push"] == groups
            assert counts["delta_apply_coo"] == 0
            assert counts["alias_build"] == (groups if extra else visits)
    np.testing.assert_array_equal(models["cuda"].nwk, models["cpu"].nwk)
    np.testing.assert_array_equal(models["cuda"].nk, models["cpu"].nk)
    assert models["cpu"].nwk.sum() == corp.num_tokens
    for sid in range(readers["cpu"].num_shards):
        np.testing.assert_array_equal(readers["cuda"].read_z(sid),
                                      readers["cpu"].read_z(sid))


def test_topic_service_trains_and_serves_on_card(card):
    """TopicService on the card: train with publishes, then serve
    concurrent requests while training refreshes the snapshot; the card's
    θ equal the CPU service's bitwise for the same snapshot counts."""
    import threading

    from repro_torch import rng as jrng
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.infer.engine import EngineConfig
    from repro_torch.infer.foldin import FoldInConfig
    from repro_torch.serve import TopicService
    from repro_torch.train.async_exec import ExecConfig

    corp = synthetic_corpus(120, 900, true_topics=8, seed=2)
    cfg = tlda.LDAConfig(num_topics=24, vocab_size=900, block_tokens=1024)
    ecfg = EngineConfig(max_batch=8, foldin=FoldInConfig(num_sweeps=12,
                                                         burnin=4))
    svcs = {}
    for dev in ("cuda", "cpu"):
        svc = TopicService(cfg, ecfg, exec_cfg=ExecConfig(hot_words=60),
                           device=dev)
        svc.init_from_corpus(corp, seed=1)
        snap = svc.train(2, jrng.PRNGKey(7), publish_every=1)
        assert snap.version == svc.version == 3
        assert snap.device.type == dev
        svcs[dev] = svc
    docs = [corp.w[s:s + n] for s, n in zip(corp.doc_start[:6],
                                             corp.doc_len[:6])]
    got = svcs["cuda"].fold_in(docs, seeds=list(range(6)))
    want = svcs["cpu"].fold_in(docs, seeds=list(range(6)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.theta, w.theta)

    svc = svcs["cuda"]
    svc.start_serving(max_delay_ms=2.0)
    v0 = svc.version
    ops.reset_launch_counts()
    trainer = svc.train_async(2, jrng.PRNGKey(8), publish_every=1)
    results = []

    def client(ci):
        for i in range(4):
            results.append(svc.submit(docs[(ci + i) % 6],
                                      seed=10 * ci + i).result(timeout=120))

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    trainer.join(timeout=300)
    svc.stop_serving()
    assert len(results) == 12
    assert all(abs(r.theta.sum() - 1.0) < 1e-3 for r in results)
    assert svc.version - v0 == 3
    counts = ops.launch_counts()
    assert counts["mh_sample"] > 0 and counts["delta_push"] > 0


def _tiered_pair(card, tmp_path, v=300, k=16, hot=40, seed=0):
    """A tiered handle on the card and one on the CPU, same counts."""
    from repro_torch import ps
    dense = np.random.default_rng(seed).integers(0, 20, (v, k)).astype(
        np.int32)
    return {dev: ps.tiered_matrix_from_dense(dense, hot,
                                             str(tmp_path / dev), device=dev)
            for dev in ("cuda", "cpu")}, dense


def test_tiered_pull_on_card_matches_cpu(card, tmp_path):
    """Block pulls on the card (hot gathers on the side stream, misses
    through the pinned buffers, several pulls in flight) compose the same
    rows as the CPU's, and the caller's stream sees them after result()."""
    hs, dense = _tiered_pair(card, tmp_path)
    pulls = [hs["cuda"].pull_block(b, 50) for b in range(6)]
    pulls.append(hs["cuda"].pull(np.array([0, 299, 41, 39, 7])))
    got = [p.result().cpu() for p in pulls]
    for b in range(6):
        assert torch.equal(got[b], torch.from_numpy(dense[b * 50:
                                                          (b + 1) * 50]))
    assert torch.equal(got[6], torch.from_numpy(dense[[0, 299, 41, 39, 7]]))
    for b in range(6):
        hs["cpu"].pull_block(b, 50)
    hs["cpu"].pull(np.array([0, 299, 41, 39, 7]))
    assert (hs["cuda"].tier_stats().to_json()
            == hs["cpu"].tier_stats().to_json())


def test_tiered_push_on_card_matches_cpu(card, tmp_path):
    """Pushes split on residency: the hot half by one delta_push launch
    (reassignments) or one delta_apply_coo launch (COO) in slot space,
    the cold half into the memmap; after refreshes and a resize the
    composed table and the cold store equal the CPU's bitwise."""
    from repro_torch import ps
    hs, _ = _tiered_pair(card, tmp_path)
    rng = np.random.default_rng(3)
    for step in range(4):
        w = rng.integers(0, 300, 4096).astype(np.int32)
        zo, zn = (rng.integers(0, 16, 4096).astype(np.int32)
                  for _ in range(2))
        ch = rng.random(4096) < 0.7
        rows = rng.integers(-3, 303, 512).astype(np.int32)
        cols = rng.integers(0, 16, 512).astype(np.int32)
        vals = rng.integers(-2, 3, 512).astype(np.int32)
        for dev, h in hs.items():
            t = [torch.from_numpy(x).to(dev) for x in (w, zo, zn, ch)]
            ops.reset_launch_counts()
            h.push(ps.Reassign(t[0], t[0], t[1], t[2], t[3]))
            h.push_coo(*(torch.from_numpy(x).to(dev)
                         for x in (rows, cols, vals)))
            if dev == "cuda":
                counts = ops.launch_counts()
                assert counts["delta_push"] == 1
                assert counts["delta_apply_coo"] == 1
            h.refresh()
            if step == 2:
                h.resize_hot(90)
        assert torch.equal(hs["cuda"].to_dense().cpu(),
                           hs["cpu"].to_dense())
    for h in hs.values():
        h.flush()
    np.testing.assert_array_equal(hs["cuda"].tier.cold.to_array(),
                                  hs["cpu"].tier.cold.to_array())


def test_tiered_training_on_card_matches_cpu(card, tmp_path):
    """A small storage="tiered" job on the card and on the CPU: z, the
    composed n_wk, n_k and the cold-store files equal bitwise; the card
    launched one mh_sample, one alias_build and one delta_push per
    non-empty block a sweep, and no delta_apply_coo."""
    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(120, 900, true_topics=8, seed=2)
    out = {}
    for dev in ("cuda", "cpu"):
        job = LDAJob(corpus=corp, num_topics=24, block_tokens=1024,
                     sweeps=2, eval_every=0, storage="tiered", hot_rows=100,
                     model_blocks=6, tier_dir=str(tmp_path / dev))
        ops.reset_launch_counts()
        est = APSLDA(job, log_fn=lambda m: None, device=dev)
        model = est.fit()
        out[dev] = (model, est.result_.state, ops.launch_counts())
    counts, info = out["cuda"][2], out["cuda"][0].info
    blocks = np.unique(corp.w // info["rows_per_block"]).size
    for name in ("mh_sample", "alias_build", "delta_push"):
        assert counts[name] == blocks * 2, name
    assert counts["delta_apply_coo"] == 0
    np.testing.assert_array_equal(out["cuda"][0].nwk, out["cpu"][0].nwk)
    np.testing.assert_array_equal(out["cuda"][0].nk, out["cpu"][0].nk)
    assert torch.equal(out["cuda"][1].z.cpu(), out["cpu"][1].z)
    for name in ("coldstore.json", "table.int32"):
        assert ((tmp_path / "cuda" / name).read_bytes()
                == (tmp_path / "cpu" / name).read_bytes())


def test_pipelined_sweep_times_the_z_update_under_obs(card):
    """With an obs session installed, a pipelined sweep on the card records
    its z updates' device ms (one histogram entry a sweep); the sweep's
    values are the same with the session off."""
    from repro_torch import obs
    from repro_torch import rng as trng
    from repro_torch.api import LDAJob, Session
    from repro_torch.data.corpus import synthetic_corpus

    job = LDAJob(corpus=synthetic_corpus(120, 900, true_topics=8, seed=2),
                 num_topics=24, block_tokens=1024, sweeps=1, eval_every=0,
                 model_blocks=4)
    st, step, _ = Session(job, log_fn=lambda m: None).make_step()
    plain = step.raw(st, trng.PRNGKey(5, "cuda"))
    s = obs.ObsSession(obs.ObsConfig(enabled=True)).install()
    try:
        traced = step.raw(st, trng.PRNGKey(5, "cuda"))
        h = obs.metrics_registry().get("exec.z_update_ms")
    finally:
        s.close(save=False)
    assert h is not None and h.count == 1 and h.total > 0
    assert torch.equal(plain.z, traced.z)
