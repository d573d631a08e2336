"""The SSM families on a model axis above 1, on a mesh of gloo ranks,
against the JAX package's single device, from the same logical weights.

The smoke variants of mamba2-370m and hymba-1.5b (float32, remat on), a
hymba case with the sequence-parallel prefill (``seq_parallel_attn``), and
a mamba whose 3 SSD heads tile no model axis (``"gather"`` mode) are
carried from the JAX ``init_params`` (constant leaves perturbed, so that
gates, norm scales and ``D`` matter) into each rank's blocks on meshes of
data 2 x model 2 and data 1 x model 4 (the SSM split by heads: its
regrouped ``in_proj`` and conv columns, ``models/ssm.py``).  Serving: the
prompt's full-sequence logits and 4 teacher-forced decode steps within
rtol 1e-5 and atol 1e-6 of the row's largest logit of the JAX package's
``forward`` and ``decode_step``.  Training: one step with microbatch 2
(``loop.step_grads`` then ``loop.apply_grads``) against
``jax.value_and_grad`` and ``repro.train.optimizer.apply``: the loss
within rtol 1e-5, every logical gradient, both moments and the updated
parameters within rtol 1e-4 and atol 1e-5 of the leaf's largest (a
parameter also within its first-step band).  One spawn of 4 ranks per
mesh serves every case.  The heads-split mixer's backward (the gated norm
over the split ``d_inner``, ``B``/``C``'s ``model_copy``, the input's) is
held to finite differences in float64 on 2 gloo ranks.
"""
import dataclasses
import functools
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import MeshLayout, ctx_for
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import specs as tspecs
from test_torch_lm_mesh_train import _close, _perturb, first_step_band

CASES = ["mamba2-370m", "hymba-1.5b", "hymba-seq-parallel", "gather"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, SP, STEPS = 2, 12, 4          # serving: batch, prompt, decode steps
TB, TS, MB = 4, 16, 2            # training: batch, sequence, microbatches
RTOL, ATOL = 1e-5, 1e-6          # logits; atol: of the row's largest
LOSS_RTOL = 1e-5
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
          microbatch=MB)


def _cfgs(case):
    name = {"gather": "mamba2-370m",
            "hymba-seq-parallel": "hymba-1.5b"}.get(case, case)
    over = {"remat": True}
    if case == "gather":
        over.update(ssm_expand=3, ssm_head_dim=128)     # 3 SSD heads
    if case == "hymba-seq-parallel":
        over["seq_parallel_attn"] = True
    return (dataclasses.replace(jreg.smoke_variant(name), **over),
            dataclasses.replace(treg.smoke_variant(name), **over))


def _jax_case(case):
    """The JAX package's single device: the serving logits (the prompt's
    every position, then STEPS decode steps fed the next tokens) and one
    train step (the microbatches' gradients accumulated in float32, then
    ``optimizer.apply``)."""
    jcfg, _ = _cfgs(case)
    params = _perturb(jtfm.init_params(jax.random.PRNGKey(0), jcfg), 1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B, SP + STEPS)).astype(
        np.int32)
    full, _, _ = jtfm.forward(params, jnp.asarray(tokens[:, :SP]), jcfg,
                              remat=False)
    _, caches = jtfm.prefill(params, jnp.asarray(tokens[:, :SP]), jcfg)

    def grow(path, a):
        if str(path[-1].key) in ttfm.SEQ_LEAVES:
            widths = [(0, 0)] * a.ndim
            widths[2] = (0, STEPS)
            return jnp.pad(a, widths)
        return a

    caches = jax.tree_util.tree_map_with_path(grow, caches)
    rows = [np.asarray(full)]
    for i in range(SP, SP + STEPS):
        lg, caches = jtfm.decode_step(params, jnp.asarray(tokens[:, i]),
                                      caches, jnp.int32(i), jcfg)
        rows.append(np.asarray(lg)[:, None])

    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (TB, TS)).astype(
                 np.int32),
             "targets": rng.integers(0, jcfg.vocab_size, (TB, TS)).astype(
                 np.int32),
             "mask": (rng.random((TB, TS)) > 0.2).astype(np.float32)}
    vg = jax.jit(jax.value_and_grad(
        lambda p, tok, tgt, msk: jtfm.loss_fn(p, tok, tgt, msk, jcfg),
        has_aux=True))
    acc = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), params)
    n, losses = TB // MB, []
    for i in range(MB):
        part = {k: jnp.asarray(v[i * n:(i + 1) * n])
                for k, v in batch.items()}
        (loss, _), g = vg(params, part["tokens"], part["targets"],
                          part["mask"])
        acc = jax.tree.map(lambda a, x: a + x.astype(jnp.float32) / MB,
                           acc, g)
        losses.append(float(loss))
    tc = JTrainConfig(**TC)
    p, state, om = jax.jit(lambda g, st, q: jopt.apply(g, st, q, tc))(
        acc, jopt.init(params), params)
    host = functools.partial(jax.tree.map, np.asarray)
    return {"params": host(params), "tokens": tokens,
            "logits": np.concatenate(rows, axis=1), "batch": batch,
            "loss": float(np.mean(losses)),
            "grad_norm": float(om["grad_norm"]), "grads": host(acc),
            "new_params": host(p), "m": host(state.m), "v": host(state.v)}


@pytest.fixture(scope="module")
def jax_refs():
    # the single device runs no sequence-parallel prefill: that case's
    # reference is hymba's
    out = {case: _jax_case(case) for case in CASES
           if case != "hymba-seq-parallel"}
    out["hymba-seq-parallel"] = out["hymba-1.5b"]
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_results(request, jax_refs):
    """Every case on one mesh of 4 gloo ranks: the serving logits
    (logical vocab order), then a train step's gradient, metrics and
    state (logical, as JAX pytrees)."""
    from repro_torch.train.mesh_worker import LMTrainRun

    data, model = MESHES[request.param]
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the helpers' thread count
    try:
        with LMTrainRun({"data": data, "model": model}, torch.device("cpu"),
                        timeout_s=120) as run:
            for case in CASES:
                ref = jax_refs[case]
                _, tcfg = _cfgs(case)
                run.call("load", tcfg, params=ref["params"])
                res = run.call("logits", torch.from_numpy(ref["tokens"]),
                               STEPS)
                lay = ttfm.vocab_layout(tcfg,
                                        ctx_for(MeshLayout(data, model)))
                phys = torch.as_tensor(lay.to_physical(
                    torch.arange(tcfg.vocab_size)))
                got = {"logits": res["logits"][..., phys].numpy()}
                run.call("train_init", tcfg, TrainConfig(**TC),
                         params=ref["params"])
                got["grad_metrics"] = run.call("train_grads", ref["batch"])
                got.update(run.arrays(tcfg, "grads"))
                got["metrics"] = run.call("train_apply")
                got.update(run.arrays(tcfg, "params", "m", "v"))
                out[case] = got
    finally:
        torch.set_num_threads(threads)
    return request.param, out


@pytest.mark.parametrize("case", CASES)
def test_mesh_ssm_logits_match_jax_single_device(mesh_results, jax_refs,
                                                 case):
    mesh, out = mesh_results
    got, want = out[case]["logits"], jax_refs[case]["logits"]
    assert got.shape == want.shape, (mesh, case)
    scale = np.abs(want).max(-1, keepdims=True)
    err = np.abs(got - want) - RTOL * np.abs(want) - ATOL * scale
    assert float(err.max()) <= 0.0, (mesh, case, float(
        (np.abs(got - want) / scale).max()))


@pytest.mark.parametrize("case", CASES)
def test_mesh_ssm_train_step_matches_jax_single_device(mesh_results,
                                                       jax_refs, case):
    mesh, out = mesh_results
    res, want = out[case], jax_refs[case]
    np.testing.assert_allclose(res["grad_metrics"]["loss"], want["loss"],
                               rtol=LOSS_RTOL, err_msg=(mesh, case))
    np.testing.assert_allclose(res["metrics"]["grad_norm"],
                               want["grad_norm"], rtol=1e-5,
                               err_msg=(mesh, case))
    _close(res["grads"], want["grads"], f"{mesh} {case} grad")
    _close(res["m"], want["m"], f"{mesh} {case} m")
    _close(res["v"], want["v"], f"{mesh} {case} v")
    tc = TrainConfig(**TC)
    clip = min(1.0, tc.grad_clip / want["grad_norm"])
    bands = jax.tree.map(lambda g: first_step_band(
        g, clip, float(res["metrics"]["lr"]), tc.eps), want["grads"])
    _close(res["params"], want["new_params"], f"{mesh} {case} param", bands)


@pytest.mark.parametrize("shape", list(MESHES.values()))
@pytest.mark.parametrize("case", CASES)
def test_ssm_blocks_round_trip(case, shape):
    """Every rank's blocks of a JAX pytree (``lm_shard_from_arrays``: the
    regrouped SSM columns where the heads tile the axis) gathered back
    (``lm_arrays_from_shards``) are the pytree, bitwise."""
    from repro_torch import convert

    @dataclasses.dataclass(frozen=True)
    class RankLayout(MeshLayout):         # a rank's place, for the rules
        rank: int = 0

    jcfg, tcfg = _cfgs(case)
    params = jax.tree.map(np.asarray, _perturb(jtfm.init_params(
        jax.random.PRNGKey(0), jcfg), 1))
    layout = MeshLayout(*shape)
    models = [convert.lm_shard_from_arrays(
        params, tcfg, ctx_for(RankLayout(*shape, rank=r)), r, "cpu")
        for r in range(layout.data * layout.model)]
    got = convert.lm_arrays_from_shards(models, tcfg, ctx_for(layout))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_w) == set(flat_g)
    for path, w in flat_w.items():
        np.testing.assert_array_equal(flat_g[path], w,
                                      err_msg=jax.tree_util.keystr(path))


def test_ssm_split_rule_and_cache_shapes():
    """Where the mixer splits by heads, and what each rank's cache holds
    (``transformer.cache_shapes``): the heads' state and the conv tail's
    channels and shared ``B``/``C`` in ``"heads"`` mode, both whole in
    ``"gather"`` mode."""
    mamba, hymba = treg.get("mamba2-370m"), treg.get("hymba-1.5b")
    assert [tspecs.ssm_split(mamba, m) for m in (1, 2, 4, 16)] == \
        ["heads"] * 4                      # 32 heads
    assert [tspecs.ssm_split(hymba, m) for m in (2, 4)] == \
        ["heads", "gather"]                # 50 heads
    assert tspecs.ssm_split(_cfgs("gather")[1], 2) == "gather"
    four = ctx_for(MeshLayout(1, 4))
    sh = ttfm.cache_shapes(mamba, 4, 100, four)["main"]
    assert sh["ssm"][0] == (48, 4, 8, 64, 128)
    assert sh["conv"][0] == (48, 4, 3, 2048 // 4 + 256)
    sh = ttfm.cache_shapes(hymba, 4, 100, four)["main"]
    assert sh["ssm"][0] == (32, 4, 50, 64, 16)
    assert sh["conv"][0] == (32, 4, 3, 3200 + 32)
    assert sh["k"][0] == (32, 4, 100, 5, 64)
    # data 2: a batch of 1 is sequence-sharded, 101 slots padded to 2 x 51
    sh = ttfm.cache_shapes(hymba, 1, 101, ctx_for(MeshLayout(2, 2)),
                           seq_shard=True)["main"]
    assert sh["k"][0] == (32, 1, 51, 5, 64)
    assert sh["ssm"][0] == (32, 1, 25, 64, 16)


# ---------------------------------------------------------------------------
# The heads-split mixer's backward against finite differences (float64)
# ---------------------------------------------------------------------------

EPS = 1e-6
FD_CFG = dict(name="fd-ssm", arch_type="ssm", num_layers=1, d_model=4,
              num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=16,
              ssm_state=2, ssm_expand=2, ssm_head_dim=2, ssm_chunk=2,
              ssm_conv_width=2, dtype="float64")


def _fd_rank(rank, store, out_dir):
    """One rank of a 1 x 2 mesh: the SSM mixer (4 heads, 2 a rank) in
    float64 on a replicated input, the loss ``sum(out * w)`` (the same on
    both ranks); its autograd gradient of each block and of the input,
    and central differences of the loss over every logical weight and
    input element (both ranks step together)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.layers import full_shape
    from repro_torch.models.ssm import SSM

    torch.set_num_threads(1)
    mesh = Mesh.init(rank, 1, 2, "gloo", torch.device("cpu"), store, 60)
    try:
        cfg = ModelConfig(**FD_CFG)
        ctx = ctx_for(mesh)
        ssm = SSM(cfg, ctx=ctx).double()
        assert ssm.tp
        g = torch.Generator().manual_seed(5)
        logical = {n: torch.randn(full_shape(p), generator=g,
                                  dtype=torch.float64)
                   for n, p in ssm.named_parameters()}
        x = torch.randn((2, 4, 4), generator=g, dtype=torch.float64)
        w = torch.randn((2, 4, 4), generator=g, dtype=torch.float64)

        def load(vals):
            with torch.no_grad():
                for n, p in ssm.named_parameters():
                    p.copy_(ttfm.shard_leaf("ssm." + n, vals[n], cfg, ctx,
                                            rank))

        def loss(xv):
            return torch.sum(ssm(xv)[0] * w)

        load(logical)
        xg = x.clone().requires_grad_(True)
        loss(xg).backward()
        grads = {n: p.grad.clone() for n, p in ssm.named_parameters()}
        numeric = {}
        with torch.no_grad():
            for n, v in logical.items():
                num = torch.zeros_like(v)
                for i in range(v.numel()):
                    vals = dict(logical)
                    for sign in (1, -1):
                        t = v.clone()
                        t.view(-1)[i] += sign * EPS
                        vals[n] = t
                        load(vals)
                        num.view(-1)[i] += sign * float(loss(x)) / (2 * EPS)
                numeric[n] = num
            load(logical)
            num = torch.zeros_like(x)
            for i in range(x.numel()):
                for sign in (1, -1):
                    t = x.clone()
                    t.view(-1)[i] += sign * EPS
                    num.view(-1)[i] += sign * float(loss(t)) / (2 * EPS)
        torch.save({"grads": grads, "numeric": numeric, "x_grad": xg.grad,
                    "x_numeric": num},
                   os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        mesh.close()


def test_ssm_heads_backward_matches_finite_differences(tmp_path):
    """The heads-split mixer on 2 gloo ranks, float64: every logical
    weight's gradient (each rank's block, regrouped columns gathered back
    by ``unshard_leaf``) and the input's, against central differences of
    the loss.  The gated norm over the split ``d_inner`` needs its sum's
    backward all-reduced, ``B``/``C``'s weight columns and conv channels
    and the input their ``model_copy``: each missed one shows here."""
    from repro_torch.configs.base import ModelConfig

    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_fd_rank, args=(r, store, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    res = [torch.load(tmp_path / f"r{r}.pt") for r in range(2)]
    cfg = ModelConfig(**FD_CFG)
    layout = ctx_for(MeshLayout(1, 2))
    for name, num in res[0]["numeric"].items():
        got = ttfm.unshard_leaf("ssm." + name,
                                [r["grads"][name] for r in res], cfg,
                                layout)
        err = float((got - num).abs().max() / num.abs().max())
        assert err < 1e-6, (name, err)
    for r in res:
        err = float((r["x_grad"] - r["x_numeric"]).abs().max()
                    / r["x_numeric"].abs().max())
        assert err < 1e-6, ("input", err)


def test_ssd_gradient_is_finite_where_the_masked_decay_overflows():
    """Large steps (dt A down to -32 a position) make the masked upper
    triangle's ``exp(seg)`` overflow float32 inside a chunk: the chunked
    scan masks before ``exp``, so its output and gradients equal the
    plain recurrence's (float64) and no gradient is NaN (0 * inf)."""
    from repro_torch.models.ssm import ssd_chunked

    g = torch.Generator().manual_seed(3)
    b, t, h, p, n = 1, 32, 2, 4, 3
    x = torch.randn((b, t, h, p), generator=g)
    dt = 2.0 * torch.rand((b, t, h), generator=g) + 0.5
    a = torch.tensor([-16.0, -1.0])
    bm, cm = (torch.randn((b, t, n), generator=g) for _ in range(2))

    def recurrence(x, dt, bm, cm):
        st = torch.zeros((b, h, p, n), dtype=x.dtype)
        ys = []
        for i in range(t):
            st = st * torch.exp(dt[:, i] * a.to(x.dtype))[..., None, None] \
                + torch.einsum("bh,bn,bhp->bhpn", dt[:, i], bm[:, i], x[:, i])
            ys.append(torch.einsum("bn,bhpn->bhp", cm[:, i], st))
        return torch.stack(ys, 1), st

    ins = [v.clone().requires_grad_(True) for v in (x, dt, bm, cm)]
    y, st = ssd_chunked(ins[0], ins[1], a, ins[2], ins[3], 16)
    (y.sum() + st.sum()).backward()
    ref = [v.double().clone().requires_grad_(True) for v in (x, dt, bm, cm)]
    y_r, st_r = recurrence(*ref)
    (y_r.sum() + st_r.sum()).backward()
    np.testing.assert_allclose(y.detach(), y_r.detach(), rtol=1e-4,
                               atol=1e-5)
    for got, want in zip(ins, ref):
        assert bool(torch.isfinite(got.grad).all())
        np.testing.assert_allclose(got.grad, want.grad, rtol=1e-4,
                                   atol=1e-4)
