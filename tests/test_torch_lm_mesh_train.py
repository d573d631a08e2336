"""LM training on a mesh of gloo ranks against the JAX package's single
device, from the same logical weights.

The eight attention architectures' smoke variants (float32, remat on, the
MoE ones at capacity factor 16, where neither level of the expert-parallel
path can drop) are carried from the JAX ``init_params`` (constant leaves
perturbed, so that gates and norm scales matter) into each rank's blocks
on meshes of data 2 x model 2 and data 1 x model 4, and take a step
with microbatch 2 (``make_train_step``'s halves, ``loop.step_grads``
then ``loop.apply_grads``) on the same batch as the JAX
package's ``jax.value_and_grad(loss_fn)`` (the microbatches' gradients
accumulated in float32 as the reference's scan does) and
``repro.train.optimizer.apply``: the loss within rtol 1e-5, every logical
gradient (each rank's ZeRO slices gathered), both moments and the updated
parameters within rtol 1e-4 and atol 1e-5 of the leaf's largest.  A
parameter may also differ by as much as its gradient's tolerance can move
AdamW's first step, lr * g / (|g| + eps): up to 2 lr where the tolerance
spans 0 (a near-zero gradient takes either sign); those elements are
counted and bounded.  Each
arch then takes two more steps (``make_train_step``), three in all
against three JAX steps.  The ZeRO
blocks' shapes, the clipped norm, and each autograd collective against
finite differences (float64, gloo) are their own cases.  One spawn of 4
ranks per mesh serves every case.
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
from repro_torch.sharding import specs as tspecs
from test_torch_lm_train import assert_state_specs_match

ARCHS = [a for a in jreg.all_arch_names()
         if jreg.get(a).has_attention and jreg.get(a).ssm_state == 0]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S, MB, STEPS = 4, 16, 2, 3
LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5          # atol: times the leaf's largest
TRAJ_RTOL, NORM_RTOL = 1e-4, 1e-3  # the three-step losses and grad norms
FLIP_SHARE = 0.02                # elements allowed their band, a leaf
TC = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
          microbatch=MB)


def _cfgs(name):
    over = {"remat": True}
    if jreg.get(name).num_experts:
        over["capacity_factor"] = 16.0
    return (dataclasses.replace(jreg.smoke_variant(name), **over),
            dataclasses.replace(treg.smoke_variant(name), **over))


def _perturb(params, seed):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(f, params)


def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
        if cfg.cross_attn_mode:
            b["cond"] = rng.standard_normal(
                (B, cfg.cond_len, cfg.cond_dim_)).astype(np.float32)
        out.append(b)
    return out


def _jax_steps(name, steps):
    """``steps`` single-device steps of the JAX package: per step the
    microbatches' ``value_and_grad`` accumulated in float32 (the scan's
    ``acc + g / mb``) and ``optimizer.apply``; what each step saw and
    made, as numpy."""
    jcfg, _ = _cfgs(name)
    params = _perturb(jtfm.init_params(jax.random.PRNGKey(0), jcfg), 1)
    tc = JTrainConfig(**TC)
    batches = _batches(jcfg, steps, 2)

    def lf(p, tok, tgt, msk, cond):
        return jtfm.loss_fn(p, tok, tgt, msk, jcfg, cond=cond)

    vg = jax.jit(jax.value_and_grad(lf, has_aux=True))
    apply = jax.jit(lambda g, s, p: jopt.apply(g, s, p, tc))
    state = jopt.init(params)
    p = params
    out = {"params0": jax.tree.map(np.asarray, params), "batches": batches,
           "steps": []}
    n = B // MB
    for batch in batches:
        acc = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), p)
        losses = []
        for i in range(MB):
            part = {k: jnp.asarray(v[i * n:(i + 1) * n])
                    for k, v in batch.items()}
            (loss, _), g = vg(p, part["tokens"], part["targets"],
                              part["mask"], part.get("cond"))
            acc = jax.tree.map(lambda a, x: a + x.astype(jnp.float32) / MB,
                               acc, g)
            losses.append(float(loss))
        p, state, om = apply(acc, state, p)
        out["steps"].append({
            "loss": float(np.mean(losses)),
            "grad_norm": float(om["grad_norm"]),
            "grads": jax.tree.map(np.asarray, acc),
            "params": jax.tree.map(np.asarray, p),
            "m": jax.tree.map(np.asarray, state.m),
            "v": jax.tree.map(np.asarray, state.v)})
    return out


@functools.lru_cache(maxsize=None)
def _jax_ref(name):
    return _jax_steps(name, STEPS)


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_results(request):
    """Every arch on one mesh of 4 gloo ranks: the first step's gradient,
    metrics and state (logical, as JAX pytrees), every rank's block
    shapes, and the next steps' metrics."""
    from repro_torch.train.mesh_worker import LMTrainRun

    data, model = MESHES[request.param]
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the helpers' thread count
    try:
        with LMTrainRun({"data": data, "model": model}, torch.device("cpu"),
                        timeout_s=120) as run:
            for name in ARCHS:
                ref = _jax_ref(name)
                _, tcfg = _cfgs(name)
                run.call("train_init", tcfg, TrainConfig(**TC),
                         params=ref["params0"])
                res = {"grad_metrics": run.call("train_grads",
                                                ref["batches"][0]),
                       **run.arrays(tcfg, "grads")}
                res["metrics"] = [dict(res["grad_metrics"],
                                       **run.call("train_apply"))]
                res.update({"shapes": run.call("train_shapes"),
                            **run.arrays(tcfg, "params", "m", "v")})
                res["metrics"] += [run.call("train_step", b)
                                   for b in ref["batches"][1:]]
                out[name] = res
    finally:
        torch.set_num_threads(threads)
    return request.param, out


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def first_step_band(g, scale, lr, eps):
    """How far AdamW's first step can move each element when its gradient
    ``g`` is known to within RTOL / ATOL of the leaf's largest: the step
    moves it by lr times ``x / (|x| + eps)`` of the clipped gradient ``x``
    (the moments start at zero), so by lr times that function's range
    over ``g`` plus or minus the tolerance -- up to 2 lr where the
    tolerance spans 0 (the sign of a near-zero gradient)."""
    g = np.abs(np.asarray(g, np.float64))
    tol = ATOL * float(g.max()) + RTOL * g
    a, t = g * scale, tol * scale
    return lr * ((a + t) / (a + t + eps) - (a - t) / (np.abs(a - t) + eps))


def _close(got, want, what, bands=None):
    """Leaf by leaf within RTOL / ATOL of the leaf's largest; with
    ``bands`` (a tree of ``first_step_band``) an element may also differ
    by its band, those elements counted and bounded by FLIP_SHARE of the
    leaf."""
    flat_g = dict(_leaves(got))
    assert len(flat_g) == len(_leaves(want)), what
    band = None if bands is None else dict(_leaves(bands))
    for path, w in _leaves(want):
        w = np.asarray(w, np.float32)
        g = np.asarray(flat_g[path], np.float32)
        key = f"{what}{jax.tree_util.keystr(path)}"
        assert g.shape == w.shape, key
        tol = ATOL * float(np.abs(w).max()) + RTOL * np.abs(w)
        bad = np.abs(g - w) > tol
        if band is not None and bad.any():
            assert not (np.abs(g - w) > tol + band[path]).any(), key
            assert bad.mean() <= FLIP_SHARE, (key, float(bad.mean()))
        else:
            assert not bad.any(), (key, float(np.abs(g - w).max()))


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_train_step_matches_jax_single_device(mesh_results, name):
    mesh, out = mesh_results
    res, ref = out[name], _jax_ref(name)
    want = ref["steps"][0]
    np.testing.assert_allclose(res["grad_metrics"]["loss"], want["loss"],
                               rtol=LOSS_RTOL, err_msg=(mesh, name))
    _close(res["grads"], want["grads"], f"{mesh} {name} grad")
    _close(res["m"], want["m"], f"{mesh} {name} m")
    _close(res["v"], want["v"], f"{mesh} {name} v")
    tc = TrainConfig(**TC)
    clip = min(1.0, tc.grad_clip / want["grad_norm"])
    bands = jax.tree.map(lambda g: first_step_band(
        g, clip, float(res["metrics"][0]["lr"]), tc.eps), want["grads"])
    _close(res["params"], want["params"], f"{mesh} {name} param", bands)


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_three_steps_match_jax(mesh_results, name):
    """Three steps against three JAX single-device steps: the losses and
    grad norms step by step."""
    mesh, out = mesh_results
    got = out[name]["metrics"]
    want = _jax_ref(name)["steps"]
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=TRAJ_RTOL,
                                   err_msg=(name, i))
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=NORM_RTOL, err_msg=(name, i))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "gemma3-4b"])
def test_zero_blocks_are_local_shape_of_opt_state_specs(mesh_results,
                                                        name):
    """Every rank's moment block is ``local_shape`` of the leaf under its
    ``opt_state_specs`` spec (the parameter block cut once more over the
    data axis where the mesh has one), and its parameter block that of
    ``param_specs``."""
    mesh, out = mesh_results
    layout = MeshLayout(*MESHES[mesh])
    ctx = ctx_for(layout)
    split = 0
    for rank, leaves in enumerate(out[name]["shapes"]):
        for leaf, sh in leaves.items():
            path = tspecs.path_str(leaf)
            pspec = tspecs.spec_for(path, len(sh["param"]), ctx)
            grid = tspecs.shard_grid(pspec, layout, rank)
            logical = tuple(s * n for s, (n, _) in zip(sh["param"], grid)) \
                + sh["param"][len(grid):]
            ospec = tspecs.P(*sh["spec"])
            assert sh["moment"] == tspecs.local_shape(logical, ospec,
                                                      layout), (rank, leaf)
            split += sh["moment"] != sh["param"]
    assert (split > 0) == (layout.data > 1), (mesh, split)


def test_clipped_grad_norm_is_the_logical_norm(mesh_results):
    """The step's grad norm (each rank's ZeRO slices' squares, each block
    counted once) equals the norm of the gathered logical gradient and
    the JAX package's, with the clip on."""
    mesh, out = mesh_results
    for name in ARCHS:
        res, want = out[name], _jax_ref(name)["steps"][0]
        logical = float(np.sqrt(sum(
            np.sum(np.square(np.asarray(g, np.float64)))
            for _, g in _leaves(res["grads"]))))
        gn = res["metrics"][0]["grad_norm"]
        assert gn > TrainConfig().grad_clip, (mesh, name, gn)
        np.testing.assert_allclose(gn, logical, rtol=1e-5,
                                   err_msg=(mesh, name))
        np.testing.assert_allclose(gn, want["grad_norm"], rtol=1e-5,
                                   err_msg=(mesh, name))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "gemma3-4b"])
def test_train_state_from_arrays_round_trips_zero_blocks(name):
    """Every rank's state of a 2 x 2 layout carried from a JAX
    ``TrainState`` (``convert.train_state_from_arrays``): its moment blocks
    are the ZeRO blocks of ``opt_state_specs``, and every rank's blocks
    gathered back (``lm_arrays_from_shards``) are the JAX state, bitwise."""
    from repro_torch import convert
    from repro_torch.train import loop as tloop

    @dataclasses.dataclass(frozen=True)
    class RankLayout(MeshLayout):         # a rank's place, for the rules
        rank: int = 0

    jcfg, tcfg = _cfgs(name)
    params = jax.tree.map(np.asarray, _perturb(jtfm.init_params(
        jax.random.PRNGKey(0), jcfg), 1))
    rng = np.random.default_rng(3)
    st = jopt.init(params)
    st = jopt.AdamWState(
        jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), st.m),
        jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), st.v),
        np.int32(5))
    layout = MeshLayout(2, 2)
    states, specs_ = [], None
    for r in range(4):
        ctx = ctx_for(RankLayout(2, 2, rank=r))
        state = convert.train_state_from_arrays(params, st, tcfg, "cpu", ctx)
        specs_ = tloop.state_specs(state, ctx)["opt"].m
        for leaf, p in state.model.named_parameters():
            grid = tspecs.shard_grid(tspecs.spec_for(
                tspecs.path_str(leaf), p.dim(), ctx), layout, r)
            logical = tuple(n * g for n, (g, _) in zip(p.shape, grid)) + \
                tuple(p.shape[len(grid):])
            assert tuple(state.opt.m[leaf].shape) == tspecs.local_shape(
                logical, specs_[leaf], layout), (r, leaf)
        assert int(state.opt.step) == 5
        states.append(state)
    lctx = ctx_for(layout)
    for tree, got in ((params, convert.lm_arrays_from_shards(
            [s.model for s in states], tcfg, lctx)),
                      (st.m, convert.lm_arrays_from_shards(
            [s.opt.m for s in states], tcfg, lctx, spec_of=specs_)),
                      (st.v, convert.lm_arrays_from_shards(
            [s.opt.v for s in states], tcfg, lctx, spec_of=specs_))):
        for (path, a), b in zip(_leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=str(path))


def test_mesh_state_specs_are_the_reference_state_specs():
    """``loop.state_specs`` of a rank's model on a 2 x 2 layout against
    the JAX ``state_specs`` (``assert_state_specs_match``)."""
    for name in ("deepseek-v2-lite-16b", "gemma3-4b",
                 "llama-3.2-vision-11b"):
        assert_state_specs_match(*_cfgs(name), MeshLayout(2, 2))


# ---------------------------------------------------------------------------
# The autograd collectives on gloo, against finite differences
# ---------------------------------------------------------------------------

EPS = 1e-6
# (name, per-rank input shape, consumer: "same" -- every rank computes
# the same loss from a replicated result -- or "own" -- each rank its own
# part, the losses added over the ranks)
COLLECTIVES = [("mesh_sum", (3, 2), "same"), ("mesh_copy", (3, 2), "own"),
               ("gather_replicated", (2, 3), "same"),
               ("gather_reduce_scatter", (2, 3), "own"),
               ("all_to_all", (4, 2), "own")]


def _collective(name, x, comm):
    from repro_torch.models import layers
    axis = ("data", "model")
    if name == "mesh_sum":
        return layers.mesh_sum(x, comm, axis, "t")
    if name == "mesh_copy":
        return layers.mesh_copy(x, comm, axis, "t")
    if name == "gather_replicated":
        return layers.gather_dim(x, comm, axis, 1, "t", True)
    if name == "gather_reduce_scatter":
        return layers.gather_dim(x, comm, axis, 1, "t", False)
    return layers.all_to_all(x, comm, axis, "t")


def _rank_checks(rank, store, out_dir):
    from repro_torch.launch.mesh import Mesh
    torch.set_num_threads(1)
    mesh = Mesh.init(rank, 2, 2, "gloo", torch.device("cpu"), store, 60)
    res = {}
    try:
        for name, shape, consumer in COLLECTIVES:
            g = torch.Generator().manual_seed(7)
            xs = torch.randn((mesh.world, *shape), generator=g,
                             dtype=torch.float64)
            if name == "mesh_copy":
                xs[:] = xs[0]              # a replicated input
            out_shape = _collective(name, xs[rank], mesh).shape
            ws = torch.randn((mesh.world, *out_shape), generator=g,
                             dtype=torch.float64)
            w = ws[0] if consumer == "same" else ws[rank]
            x = xs[rank].clone().requires_grad_(True)
            torch.sum(_collective(name, x, mesh) * w).backward()
            analytic = x.grad.clone()

            def loss(xr):
                with torch.no_grad():
                    val = torch.sum(_collective(name, xr, mesh) * w)
                    if consumer == "own":
                        val = mesh.all_reduce(val.reshape(1),
                                              ("data", "model"))[0]
                return float(val)

            # every rank steps through the global elements together
            numeric = torch.zeros_like(xs)
            for r in range(mesh.world):
                for i in range(xs[r].numel()):
                    if name == "mesh_copy" and r:
                        continue           # one replicated input
                    xp = xs[rank].clone()
                    xm = xs[rank].clone()
                    if rank == r or name == "mesh_copy":
                        xp.view(-1)[i] += EPS
                        xm.view(-1)[i] -= EPS
                    numeric[r].view(-1)[i] = (loss(xp) - loss(xm)) / (2 * EPS)
            want = numeric[0] if name == "mesh_copy" else numeric[rank]
            res[name] = float((analytic - want).abs().max()
                              / want.abs().max())
        torch.save(res, os.path.join(out_dir, f"r{rank}.pt"))
    finally:
        mesh.close()


def test_autograd_collectives_match_finite_differences(tmp_path):
    """Each collective's backward on 4 gloo ranks (2 x 2, over the world)
    in float64 against central differences of the global loss, every
    rank's input element stepped in turn on every rank: the sum (identity
    backward), the copy (all-reduce backward), the gather with a
    replicated consumer (the rank's block) and with per-rank consumers
    (reduce-scatter), the all-to-all (the reverse exchange)."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=_rank_checks, args=(r, store, str(tmp_path)))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0, p.exitcode
    for r in range(4):
        res = torch.load(tmp_path / f"r{r}.pt")
        assert set(res) == {c[0] for c in COLLECTIVES}
        for name, err in res.items():
            assert err < 1e-6, (r, name, err)
