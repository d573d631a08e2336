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


@pytest.mark.parametrize("n,stride", [(3000, 8192), (400_000, 1_000_000)],
                         ids=["split", "whole"])
def test_mh_draws_train_kernel_keeps_the_stride(card, n, stride):
    """``n`` slots drawn at a counter ``stride`` are the first ``n``
    columns of each step of the kernel's draw at ``stride`` slots and the
    plain draw at the same stride, bitwise, in one launch.  3,000 slots
    fill no wave of blocks (the split layout); 400,000 give 1,563 blocks
    of 256 threads, past the H100's resident blocks at any occupancy (132
    SMs x 8): a thread per slot."""
    rng = np.random.default_rng(n)
    lens = rng.integers(0, 400, 5000).astype(np.int32)
    lens[::7], lens[1::7] = 0, 1
    start = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    z = rng.integers(0, 130, int(lens.sum())).astype(np.int32)
    d = rng.integers(0, lens.size, stride).astype(np.int32)
    d_b, z, start, lens = (torch.from_numpy(x).to(card)
                           for x in (d, z, start, lens))
    cfg = tlda.LDAConfig(num_topics=130, vocab_size=50, mh_steps=3)
    key = torch.tensor([0x9E3779B9, n], dtype=torch.int64, device=card)
    full = ops.mh_draws_train(key, d_b, z, start, lens, stride, cfg)
    before = ops.launch_counts()["mh_draws_train"]
    got = ops.mh_draws_train(key, d_b[:n], z, start, lens, n, cfg,
                             stride=stride)
    assert ops.launch_counts()["mh_draws_train"] == before + 1
    want = ref.mh_draws_train_ref(key, d_b[:n], z, start, lens, n, cfg,
                                  stride)
    for name, g, f, w in zip(got._fields, got, full, want):
        assert g.shape == (3, n)
        assert torch.equal(g, f[:, :n]), name
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


@pytest.mark.parametrize("nkeys,data,num", [(1, (), 244), (32, (), 2),
                                             (1, (1, 3, 17), 0),
                                             (32, (0x1d4,), 0),
                                             (4, (0, 5), 3)])
def test_threefry_keys_kernel_matches_plain_bitwise(card, nkeys, data, num):
    """split and fold-in chains in one launch, as the LDA paths take them."""
    from repro_torch import rng as trng
    keys = trng.keys_from_seeds(range(9, 9 + nkeys), card)
    if nkeys == 1:
        keys = keys[0]
    before = ops.launch_counts()["threefry_keys"]
    got = ops.fold_in(keys, *data) if not num else ops.split(
        ops.fold_in(keys, *data) if data else keys, num)
    assert ops.launch_counts()["threefry_keys"] == before + (
        2 if data and num else 1)
    assert torch.equal(got, ref.threefry_keys_ref(keys, data, num))


@pytest.mark.parametrize("nkeys,m,lo,hi,data", [
    (32, 1024, 0, 7, (0x1d4,)), (32, 1024, 0, 130, (0x1d4,)),
    (32, 1024, 0, 1000, (0x1d4,)), (1, 262_144, 0, 1000, (0, 5)),
    (3, 1000, -5, 2 ** 31 - 1, ())])
def test_threefry_randint_kernel_matches_plain_bitwise(card, nkeys, m, lo,
                                                       hi, data):
    """Serving's init draw, a stream shard's, and a range past int32's
    half; one launch each."""
    from repro_torch import rng as trng
    keys = trng.keys_from_seeds(range(50, 50 + nkeys), card)
    if nkeys == 1:
        keys = keys[0]
    before = ops.launch_counts()["threefry_randint"]
    got = ops.randint(keys, (m,), lo, hi, fold_in=data)
    assert ops.launch_counts()["threefry_randint"] == before + 1
    assert torch.equal(got, ref.threefry_randint_ref(keys, (m,), lo, hi,
                                                     data))


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


def test_pipelined_sweep_phases_on_the_card(card, monkeypatch):
    """With an obs session installed, a pipelined sweep on the card times
    its phases by CUDA events and waits for none of them: the wrapped step
    synchronises once, in its own wait, and its device phases land on the
    ``[device]`` lane with positive durations.  The sweep's values are the
    same with the session off."""
    from repro_torch import obs
    from repro_torch import rng as trng
    from repro_torch.api import LDAJob, Session
    from repro_torch.data.corpus import synthetic_corpus

    job = LDAJob(corpus=synthetic_corpus(120, 900, true_topics=8, seed=2),
                 num_topics=24, block_tokens=1024, sweeps=1, eval_every=0,
                 model_blocks=4)
    st, step, info = Session(job, log_fn=lambda m: None).make_step()
    plain = step(st, trng.PRNGKey(5, "cuda"))
    torch.cuda.synchronize()
    waits = []

    def counted(real):
        def wait(*a, **k):
            waits.append(real)
            return real(*a, **k)
        return wait

    monkeypatch.setattr(torch.cuda, "synchronize",
                        counted(torch.cuda.synchronize))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        counted(torch.cuda.Event.synchronize))
    s = obs.ObsSession(obs.ObsConfig(enabled=True)).install()
    try:
        traced = step(st, trng.PRNGKey(5, "cuda"))
        n_waits = len(waits)
    finally:
        s.close(save=False)
    assert n_waits == 1
    for a, b in ((plain.z, traced.z), (plain.nwk.value, traced.nwk.value),
                 (plain.nk.value, traced.nk.value), (plain.ndk, traced.ndk)):
        assert torch.equal(a, b)
    device = [e for e in s.tracer.events()
              if e.get("ph") == "X" and e["cat"] == "cuda"]
    groups = info["n_blocks"] // info["group"]
    assert sum(e["name"] == "sweep.device" for e in device) == 1
    write_z = [e for e in device if e["name"] == "exec.write_z"]
    assert len(write_z) == groups
    assert all(e["dur"] > 0 for e in write_z)
    assert all(e["dur"] > 0 for e in device
               if e["name"] in ("sweep.device", "kern.draws", "kern.sample"))


@pytest.mark.parametrize("extra", [{"hot_words": 60}, {"staleness": 1}],
                         ids=["hybrid", "dense"])
def test_spmd_ranks_sharing_the_card_match_the_cpu(card, extra):
    """Two SPMD ranks sharing the card (gloo: NCCL refuses two ranks on
    one GPU) equal two ranks on the CPU bitwise in n_wk, n_k, z and n_dk;
    each rank ran the training kernels on the card: one mh_draws_train,
    mh_sample and delta_push a group (the routed push's dense part), and
    with the hybrid route one delta_apply_coo (its gathered COO part)."""
    from repro_torch.api import APSLDA, LDAJob
    from repro_torch.data.corpus import synthetic_corpus

    corp = synthetic_corpus(120, 900, true_topics=8, seed=2)
    job = LDAJob(corpus=corp, num_topics=24, block_tokens=1024, sweeps=2,
                 eval_every=0, backend="spmd", mesh_model=2, **extra)
    out = {}
    for dev in ("cuda", "cpu"):
        est = APSLDA(job, log_fn=lambda m: None, device=dev, devices=2)
        est.fit()
        out[dev] = est.result_
    gpu, cpu = out["cuda"], out["cpu"]
    assert gpu.info["collective"] == ("nccl" if torch.cuda.device_count()
                                      >= 2 else "gloo")
    for a, b in ((gpu.nwk.value, cpu.nwk.value), (gpu.nk.value, cpu.nk.value),
                 (gpu.state.z, cpu.state.z), (gpu.state.ndk, cpu.state.ndk)):
        assert torch.equal(a.cpu(), b)
    for rank in gpu.info["ranks"]:
        n = rank["launches"]
        groups = n["mh_sample"]
        assert groups > 0 and rank["steps"] == job.sweeps
        assert n["mh_draws_train"] == n["delta_push"] == groups
        assert n["delta_apply_coo"] == (groups if "hot_words" in extra
                                        else 0)
        assert n["alias_build"] == job.sweeps


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.append(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("route", ["dense", "hybrid"])
def test_replay_on_card_matches_cpu(card, route):
    """obs.exec_trace's replay of a blocked sweep at V = 3,000, K = 64 on
    the card equals the CPU's bitwise (z, n_wk, n_k, n_dk), and on the card
    it launched per group one mh_draws_train, alias_build and mh_sample and
    what the route's group-local delta issues."""
    from repro_torch import obs
    from repro_torch import ps
    from repro_torch import rng as trng
    from repro_torch.api import LDAJob, Session
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.obs import exec_trace
    from repro_torch.train.async_exec import blocked_geometry

    job = LDAJob(corpus=synthetic_corpus(300, 3000, true_topics=16, seed=0),
                 num_topics=64, sweeps=1, eval_every=0, seed=0)
    rt = ps.DenseRoute() if route == "dense" else ps.HybridRoute(200)
    out = {}
    for dev in ("cuda", "cpu"):
        session = Session(job, log_fn=lambda m: None, device=dev)
        st, _, _ = session.make_step()
        ops.reset_launch_counts()
        s = obs.ObsSession(obs.ObsConfig(enabled=True)).install()
        try:
            out[dev] = exec_trace.traced_pipelined_sweep(
                st, trng.PRNGKey(4, dev), session.cfg, model_blocks=4,
                staleness=1, route=rt)
        finally:
            s.close(save=False)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
    gpu, cpu = out["cuda"], out["cpu"]
    for a, b in ((gpu.z, cpu.z), (gpu.nwk.value, cpu.nwk.value),
                 (gpu.nk.value, cpu.nk.value), (gpu.ndk, cpu.ndk)):
        assert torch.equal(a.cpu(), b)
    rpb, n_blocks, stale = blocked_geometry(cpu.nwk.layout, 4, 1)
    group_rows = rpb * (stale + 1)
    cs = _chip_smoke()
    filled = cs.groups_filled(st, group_rows)
    assert counts == cs.replay_launches(rt, group_rows,
                                        n_blocks // (stale + 1), filled)
    # the sweep's keys in one threefry_keys launch; no initial draw
    assert counts["threefry_keys"] == 1 and counts["threefry_randint"] == 0


def test_pipelined_prefix_on_card_matches_cpu(card):
    """A corpus whose tokens crowd into physical block 0 of 6 and leave
    block 3 empty (its words moved onto block 0's rows): one pipelined
    sweep at staleness 0 on the card equals the CPU's bitwise (z, n_wk,
    n_k, n_dk) and the synchronous oracle's.  Each group works its valid
    prefix alone, so an empty group (block 3, and the blocks of the
    rarest words) launches no per-slot kernel: one mh_draws_train,
    mh_sample and delta_push a group that holds a token, one alias_build
    for each of the six groups."""
    from repro_torch import rng as trng
    from repro_torch.core.pserver import CyclicLayout
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.train import async_exec

    blocks, empty = 6, 3
    corp = synthetic_corpus(300, 3000, true_topics=16, seed=0)
    cfg = tlda.LDAConfig(num_topics=64, vocab_size=3000, num_shards=2)
    layout = CyclicLayout(cfg.V, cfg.num_shards)
    rpb = layout.pad_rows // blocks
    phys = layout.to_physical(corp.w.astype(np.int64))
    w = np.where(phys // rpb == empty, layout.to_logical(phys - empty * rpb),
                 corp.w).astype(np.int32)
    valid = np.ones(w.size, bool)
    idx, bval = tlda.block_token_index(w, valid, rpb, layout)
    counts = bval.sum(1).tolist()
    assert counts[empty] == 0 and counts[0] > sum(counts) / 2
    filled = sum(1 for c in counts if c)
    out = {}
    for dev in ("cuda", "cpu"):
        st = tlda.init_state(trng.PRNGKey(0, dev),
                             torch.from_numpy(w).to(dev),
                             torch.from_numpy(corp.d).to(dev),
                             corp.num_docs, cfg)
        args = (st, trng.PRNGKey(7, dev), cfg,
                torch.from_numpy(idx).to(dev), torch.from_numpy(bval).to(dev),
                rpb)
        ops.reset_launch_counts()
        out[dev] = async_exec.pipelined_sweep(*args, block_counts=counts)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        else:
            oracle = tlda.sweep_blocked_ref(*args)
    gpu, cpu = out["cuda"], out["cpu"]
    for a, b, c in ((gpu.z, cpu.z, oracle.z),
                    (gpu.nwk.value, cpu.nwk.value, oracle.nwk.value),
                    (gpu.nk.value, cpu.nk.value, oracle.nk.value),
                    (gpu.ndk, cpu.ndk, oracle.ndk)):
        assert torch.equal(a.cpu(), b) and torch.equal(b, c)
    assert launches == {"mh_sample": filled, "alias_build": blocks,
                        "delta_push": filled, "delta_apply_coo": 0,
                        "mh_draws_train": filled, "mh_draws_foldin": 0,
                        "threefry_keys": 1, "threefry_randint": 0,
                        "mla_fwd": 0, "mla_bwd_dq": 0, "mla_bwd_dkdv": 0}


def test_baselines_on_card_match_cpu(card):
    """EM and online VB at tests/test_lda_baselines.py's size from states
    drawn on the CPU: the card's within chip_smoke.BASELINE_CASES'
    tolerances of the CPU's, and EM's perplexity within 15 % of
    LightLDA's on the card."""
    cs = _chip_smoke()
    out = cs.baselines_card_vs_cpu(torch, 0, "cuda")
    for algo, steps, rtol in cs.BASELINE_CASES:
        assert out["max_rel_err"][f"{algo}_{steps}"] <= rtol
    assert out["gap"] < cs.QUALITY_GAP


def test_lm_smoke_on_card_matches_cpu(card):
    """hymba's smoke variant (windowed GQA beside the SSD, both caches) on
    the card against the CPU from the same weights: prefill and 8 decode
    steps within chip_smoke's LM_RTOL / LM_ATOL, greedy tokens equal away
    from near ties."""
    cs = _chip_smoke()
    out = cs.lm_card_vs_cpu(torch, 0, "cuda", names=("hymba-1.5b",))
    assert out["hymba-1.5b"]["max_abs_err"] <= 1e-3


def test_bf16_attention_scores_stay_float32_on_card(card):
    """A bf16 cache on the card: _attend_decode's products accumulate and
    return float32 (cuBLAS bmm with a float32 output), so it matches the
    CPU path, which widens the operands, within one bf16 rounding of the
    output."""
    from repro_torch.models import attention as tattn
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 1, 4, 2, 256), generator=g).to(torch.bfloat16)
    k = torch.randn((2, 300, 4, 256), generator=g).to(torch.bfloat16)
    v = torch.randn((2, 300, 4, 256), generator=g).to(torch.bfloat16)
    live = slice(*tattn.live_range(290, 128))
    want = tattn._attend_decode(q, k[:, live], v[:, live])[2]
    got = tattn._attend_decode(q.to(card), k[:, live].to(card),
                               v[:, live].to(card))[2].cpu()
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_bmm_f32_backward_matches_widened_autograd(card):
    """bf16 operands through _bmm_f32 (a cuBLAS bf16 product written in
    float32, then its own backward) against autograd of the float32
    product of the widened operands: the output within float32 summation
    order, each gradient bitwise (both are the same float32 product of
    the float32 grad_out and the widened other operand, rounded to bf16)."""
    from repro_torch.models.attention import _bmm_f32
    g = torch.Generator(device=card).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card)

    a = randn(8, 96, 64).to(torch.bfloat16).requires_grad_(True)
    b = randn(8, 64, 80).to(torch.bfloat16).requires_grad_(True)
    w = randn(8, 96, 80)
    out = _bmm_f32(a, b)
    (out * w).sum().backward()
    a32 = a.detach().float().requires_grad_(True)
    b32 = b.detach().float().requires_grad_(True)
    out32 = torch.bmm(a32, b32)
    (out32 * w).sum().backward()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, out32, rtol=1e-5, atol=1e-5)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(a.grad, a32.grad.to(torch.bfloat16))
    assert torch.equal(b.grad, b32.grad.to(torch.bfloat16))


def test_bf16_attention_backward_on_card(card):
    """A bf16 attention step of smoke gemma3-4b on the card against the
    same step with every product's operands widened (chip_smoke's
    bmm_bf16_backward, BMM_BF16_TOL)."""
    cs = _chip_smoke()
    out = cs.bmm_bf16_backward(torch, 0, "cuda")
    assert out["max_rel_err"] <= cs.BMM_BF16_TOL


def test_lm_train_step_on_card_matches_cpu(card):
    """One train step of smoke gemma3-4b, and one with microbatch 2, on the
    card against the CPU from the same weights and batch: loss, gradients,
    grad norm and the updated parameters within chip_smoke's LM_* bounds."""
    cs = _chip_smoke()
    out = cs.lm_train_card_vs_cpu(torch, 0, "cuda", names=("gemma3-4b",))
    assert set(out) == {"gemma3-4b", "gemma3-4b (microbatch 2)"}
    for row in out.values():
        assert row["loss_rel_err"] <= cs.LM_LOSS_RTOL


# -- MLA's fused attention core ----------------------------------------------

MLA_SCALE = 0.1147      # DeepSeek-V2-Lite's: 192 ** -0.5 times YaRN's factor


@pytest.mark.parametrize("b,t,h", [(8, 4096, 16), (2, 1000, 2)],
                         ids=["cell", "ragged"])
def test_mla_attention_kernel_is_as_accurate_as_plain(card, b, t, h):
    """The output and each of the five gradients against float64 on the
    card: the kernel's ||x - x64|| / ||x64|| at most 1.25 times the plain
    version's (the chunked core, as MLA.forward ran it before)."""
    from repro_torch.models import attention as tattn
    cs = _chip_smoke()
    args, do = cs.mla_inputs(torch, card, b, t, h)
    want = cs.mla_f64(torch, args, do, MLA_SCALE)
    plain = cs.mla_run(torch, lambda *a: tattn._mla_attention_plain(
        *a, MLA_SCALE, q_chunk=1024, kv_chunk=2048), args, do)
    plain_err = [cs.mla_rel_err(x, w) for x, w in zip(plain, want)]
    del plain
    torch.cuda.empty_cache()
    got = cs.mla_run(torch, lambda *a: tattn.mla_attention(*a, MLA_SCALE),
                     args, do)
    for name, x, w, pe in zip(cs.MLA_PARTS, got, want, plain_err):
        assert x.dtype == torch.bfloat16 and bool(torch.isfinite(x).all())
        assert cs.mla_rel_err(x, w) <= 1.25 * pe, (name, cs.mla_rel_err(x, w),
                                                   pe)


@pytest.mark.parametrize("b,t,h,dtype", [
    (3, 1, 1, torch.bfloat16), (1, 17, 3, torch.bfloat16),
    (2, 64, 1, torch.bfloat16), (1, 129, 2, torch.bfloat16),
    (1, 200, 2, torch.float16)])
def test_mla_attention_kernel_on_short_and_ragged_rows(card, b, t, h, dtype):
    """Fewer rows than a tile, one tile's rows exactly, a tile and one
    row, and fp16: the output and the five gradients within 1 % of
    float64 (a bf16 rounding is 0.4 %).  With one row the query's and
    key's gradients are 0 (the softmax of one score is 1); the kernel's
    then differ from 0 by float32 rounding alone."""
    from repro_torch.models import attention as tattn
    cs = _chip_smoke()
    args, do = cs.mla_inputs(torch, card, b, t, h, seed=t, dtype=dtype)
    want = cs.mla_f64(torch, args, do, MLA_SCALE)
    got = cs.mla_run(torch, lambda *a: tattn.mla_attention(*a, MLA_SCALE),
                     args, do)
    for name, x, w in zip(cs.MLA_PARTS, got, want):
        assert x.dtype == dtype and x.shape == w.shape, name
        if float(w.norm()) == 0.0:
            assert float(x.abs().max()) <= 1e-3, name
            continue
        assert cs.mla_rel_err(x, w) <= 0.01, (name, cs.mla_rel_err(x, w))


def test_mla_attention_counts_its_launches(card):
    """One forward launch a call, two a backward (counted in ops.KERNELS,
    reset with the others); without gradients the same output bits, also
    with an operand that starts off 16 bytes;
    float32 takes the chunked core and launches none; head parts the
    kernel is not built for are refused on the card."""
    from repro_torch.kernels import mla_attention as fused
    from repro_torch.models import attention as tattn
    cs = _chip_smoke()
    args, do = cs.mla_inputs(torch, card, 1, 300, 2, seed=1)
    ops.reset_launch_counts()
    got = cs.mla_run(torch, lambda *a: tattn.mla_attention(*a, MLA_SCALE),
                     args, do)
    counts = ops.launch_counts()
    assert fused.launch_counts() == {"fwd": 1, "bwd": 2}
    assert (counts["mla_fwd"], counts["mla_bwd_dq"],
            counts["mla_bwd_dkdv"]) == (1, 1, 1)
    with torch.no_grad():
        assert torch.equal(tattn.mla_attention(*args, MLA_SCALE), got[0])
        # a contiguous view starting 2 bytes into its storage: copied
        off = torch.empty(args[3].numel() + 1, dtype=args[3].dtype,
                          device=card)[1:].view(args[3].shape)
        off.copy_(args[3])
        assert off.data_ptr() % 16 != 0
        assert torch.equal(tattn.mla_attention(*args[:3], off, args[4],
                                               MLA_SCALE), got[0])
    before = fused.launch_counts()
    wide = [a.float() for a in args]
    out = tattn.mla_attention(*wide, MLA_SCALE)
    assert out.dtype == torch.float32
    assert fused.launch_counts() == before
    odd = [a[..., :48].contiguous() if i in (0, 2) else a for i, a in
           enumerate(args)]
    with pytest.raises(ValueError, match="is built for head parts"):
        tattn.mla_attention(*odd, MLA_SCALE)
