"""The LM training path of the port against the JAX package, on the CPU:
the Markov-Zipf data (bitwise), AdamW on carried trees, five-step loss
trajectories from carried states, microbatch accumulation, the end-to-end
learning law, the converters and the launcher (its npz restores in the
JAX package).  Each arch's loss and gradients are in
``test_torch_lm_grads.py``, which shares this file's helpers."""
import dataclasses
import functools
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import lm_data as jdata
from repro.models import transformer as jtfm
from repro.train import checkpoint as jckpt
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch import rng as jrng
from repro_torch.api import session as tsession
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import lightlda as tlda
from repro_torch.data import lm_data as tdata
from repro_torch.data import stream as tstream
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttfm
from repro_torch.sharding.specs import MeshCtx
from repro_torch.train import async_exec as texec
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
ARCHS = jreg.all_arch_names()
QUIET = dict(log_fn=lambda *a: None)
# the tests/test_train.py model, in both packages
_TINY = dict(name="tiny", arch_type="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             head_dim=16, dtype="float32", remat=False, attn_chunk_q=32,
             attn_chunk_kv=32)
TINY, JTINY = ModelConfig(**_TINY), JModelConfig(**_TINY)
B, S = 4, 24
OPT_TOL = dict(rtol=1e-6, atol=1e-8)


def _tc(pkg_tc=TrainConfig, **kw):
    base = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    base.update(kw)
    return pkg_tc(**base)


def _perturb(params, seed):
    """Constant leaves (zero norm scales and gates, unit mixes) get noise,
    so that every one of them matters to the loss."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(f, params)


def _batches(cfg, n, batch=B, seq=S, seed=3):
    src = tdata.MarkovZipfSource(tdata.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch, seed=seed,
        cond_len=cfg.cond_len if cfg.cross_attn_mode else 0,
        cond_dim=cfg.cond_dim_ if cfg.cross_attn_mode else 0))
    return list(src.batches(n))


def _args(batch, pkg):
    keys = ["tokens", "targets", "mask"] + (["cond"] if "cond" in batch
                                            else [])
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    return [conv(batch[k]) for k in keys]


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The two configs and the JAX weights (numpy, never written)."""
    jcfg, tcfg = jreg.smoke_variant(name), treg.smoke_variant(name)
    params = _perturb(jtfm.init_params(jax.random.PRNGKey(0), jcfg), 1)
    return jcfg, tcfg, params


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=256, seq_len=32, batch_size=8, branching=2),
    dict(vocab_size=3000, seq_len=17, batch_size=3, seed=7, cond_len=4,
         cond_dim=8),
    dict(vocab_size=5000, seq_len=8, batch_size=2, zipf_exponent=1.3,
         seed=11)])
def test_markov_zipf_batches_equal_jax(kw):
    """Same seed, same successor table, transition weights and batches,
    bitwise (the placeholder draw kept, the successors drawn in one call)."""
    want = jdata.MarkovZipfSource(jdata.LMDataConfig(**kw))
    got = tdata.MarkovZipfSource(tdata.LMDataConfig(**kw))
    np.testing.assert_array_equal(got.succ, want.succ)
    np.testing.assert_array_equal(got.succ_p, want.succ_p)
    for bw, bg in zip(want.batches(3), got.batches(3)):
        assert sorted(bw) == sorted(bg)
        for k in bw:
            assert bg[k].dtype == bw[k].dtype
            np.testing.assert_array_equal(bg[k], bw[k])


def test_token_frequencies_equal_jax():
    kw = dict(vocab_size=400, seq_len=16, batch_size=4, seed=2)
    want = jdata.token_frequencies(jdata.MarkovZipfSource(
        jdata.LMDataConfig(**kw)), num_batches=5)
    got = tdata.token_frequencies(tdata.MarkovZipfSource(
        tdata.LMDataConfig(**kw)), num_batches=5)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 5 * 4 * 16


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"emb": (37, 5), "mat": (4, 3, 2), "vec": (6,), "s": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in sorted(shapes.items())}
    grads = [{k: np.asarray(rng.standard_normal(s) * 0.3, np.float32)
              for k, s in sorted(shapes.items())} for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_matches_jax_on_carried_trees(clip):
    """Four steps from the same float32 tree: parameters, moments, step, lr
    and grad norm within rtol 1e-6 (the clip on at 0.5)."""
    params, grads = _opt_trees(0)
    tc = _tc(grad_clip=clip, weight_decay=0.1)
    jtc = _tc(JTrainConfig, grad_clip=clip, weight_decay=0.1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init(tp)
    for g in grads:
        jp, js, jm = jopt.apply({k: jnp.asarray(v) for k, v in g.items()},
                                js, jp, jtc)
        tp, ts, tm = topt.apply({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp, tc)
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts.m[k], js.m[k]),
                              (ts.v[k], js.v[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           err_msg=k, **OPT_TOL)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **OPT_TOL)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32


def test_adamw_row_slices_do_not_change_the_result(monkeypatch):
    """apply cut into slices of 7 elements equals apply in one piece:
    parameters and moments bitwise (the clip off), the grad norm, whose
    sum runs in another order, within rtol 1e-6."""
    params, grads = _opt_trees(1)
    tc = _tc(grad_clip=1e9)
    out = []
    for chunk in (topt.CHUNK, 7):
        monkeypatch.setattr(topt, "CHUNK", chunk)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = topt.init(tp)
        for g in grads:
            tp, ts, tm = topt.apply({k: torch.from_numpy(v) for k, v in
                                     g.items()}, ts, tp, tc)
        out.append((tp, ts, tm))
    (pa, sa, ma), (pb, sb, mb) = out
    assert [s.start for s in topt.row_slices(pb["emb"])] == list(range(
        0, 37, 1))
    for k in params:
        assert torch.equal(pa[k], pb[k]) and torch.equal(sa.m[k], sb.m[k]) \
            and torch.equal(sa.v[k], sb.v[k])
    np.testing.assert_allclose(float(mb["grad_norm"]), float(ma["grad_norm"]),
                               **OPT_TOL)


def test_clip_by_global_norm_matches_jax():
    _, grads = _opt_trees(2)
    g = {k: np.asarray(v * 40, np.float32) for k, v in grads[0].items()}
    jc, jn = jopt.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, 1.0)
    tc_, tn = topt.clip_by_global_norm({k: torch.from_numpy(v)
                                        for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    for k in g:
        np.testing.assert_allclose(tc_[k].numpy(), np.asarray(jc[k]),
                                   **OPT_TOL)
    np.testing.assert_allclose(float(topt.global_norm(tc_)), 1.0, rtol=1e-5)


# tests/test_train.py::TestAdamW's three laws, on the port

def test_first_step_matches_manual():
    tc = TrainConfig(learning_rate=1e-2, weight_decay=0.0, warmup_steps=0,
                     total_steps=10**9, grad_clip=1e9)
    params = {"w": torch.tensor([[2.0]])}
    new_p, st2, _ = topt.apply({"w": torch.tensor([[0.5]])},
                               topt.init(params), params, tc)
    lr0 = float(topt.lr_schedule(torch.tensor(1, dtype=torch.int32), tc))
    np.testing.assert_allclose(float(new_p["w"][0, 0]),
                               2.0 - lr0 * (0.5 / (0.5 + tc.eps)), rtol=1e-5)
    assert int(st2.step) == 1


def test_weight_decay_only_matrices():
    tc = TrainConfig(learning_rate=1e-2, weight_decay=0.1, warmup_steps=0,
                     grad_clip=1e9)
    params = {"mat": torch.ones((2, 2)), "vec": torch.ones((2,))}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new_p, _, _ = topt.apply(grads, topt.init(params), params, tc)
    assert float(new_p["mat"][0, 0]) < 1.0
    np.testing.assert_allclose(new_p["vec"].numpy(), 1.0)


def test_grad_clip():
    clipped, _ = topt.clip_by_global_norm({"w": torch.full((10,), 100.0)},
                                          1.0)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)


def test_bf16_leaf_updates_in_its_dtype():
    """A bf16 parameter stays bf16 and equals the float32 arithmetic rounded
    once (no master copy); the moments are float32."""
    rng = np.random.default_rng(4)
    p32 = rng.standard_normal((8, 3)).astype(np.float32)
    g32 = rng.standard_normal((8, 3)).astype(np.float32)
    pb = torch.from_numpy(p32).to(torch.bfloat16)
    gb = torch.from_numpy(g32).to(torch.bfloat16)
    tc = _tc(grad_clip=1e9)
    params = {"w": pb.clone()}
    new_p, st, _ = topt.apply({"w": gb}, topt.init(params), params, tc)
    assert new_p["w"].dtype == torch.bfloat16 and st.m["w"].dtype == \
        torch.float32
    ref = {"w": pb.float()}
    want, _, _ = topt.apply({"w": gb.float()}, topt.init(ref), ref, tc)
    assert torch.equal(new_p["w"], want["w"].to(torch.bfloat16))


def test_sgd_apply_matches_jax():
    params, grads = _opt_trees(5)
    want = jopt.sgd_apply({k: jnp.asarray(v) for k, v in grads[0].items()},
                          {k: jnp.asarray(v) for k, v in params.items()},
                          0.1)
    got = topt.sgd_apply({k: torch.from_numpy(v) for k, v in
                          grads[0].items()},
                         {k: torch.from_numpy(v) for k, v in params.items()},
                         0.1)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **OPT_TOL)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _jax_state(params, jcfg):
    return jloop.TrainState(params, jopt.init(params))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "gemma3-4b",
                                  "llama-3.2-vision-11b", "mamba2-370m"])
def test_five_steps_match_jax(name):
    """Five make_train_step steps on the same batches from the same carried
    state: the loss trajectory within rtol 1e-4, grad norms within 1e-3.
    Step 1's update is lr * sign(g) elementwise, so a gradient near 0 may
    round to either sign: the trajectory is compared, not the parameters
    elementwise."""
    jcfg, tcfg, params = _setup(name)
    batches = _batches(tcfg, 5)
    tc, jtc = _tc(), _tc(JTrainConfig)
    jstep = jax.jit(jloop.make_train_step(jcfg, jtc))
    jstate = _jax_state(params, jcfg)
    state = convert.train_state_from_arrays(params, jstate.opt, tcfg, "cpu")
    step = tloop.make_train_step(tcfg, tc)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, *_args(batch, "jax"))
        state, tm = step(state, *_args(batch, "torch"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(state.opt.step) == 5


@pytest.mark.parametrize("name,mb", [("gemma3-4b", 2), ("yi-6b", 0)])
def test_bf16_five_steps_match_jax(name, mb):
    """The same five steps in bf16 (the gemma3-4b cell's dtype; no float32
    master copy, the microbatches' float32 accumulation): the two packages
    round bf16 products and sums in their own orders, so the losses agree
    within two bf16 roundings (2^-7), not float32's 1e-4."""
    jcfg = dataclasses.replace(jreg.smoke_variant(name), dtype="bfloat16")
    tcfg = dataclasses.replace(treg.smoke_variant(name), dtype="bfloat16")
    params = jax.tree.map(np.asarray, _perturb(jtfm.init_params(
        jax.random.PRNGKey(0), jcfg), 1))
    jstep = jax.jit(jloop.make_train_step(jcfg, _tc(JTrainConfig,
                                                    microbatch=mb)))
    jstate = _jax_state(params, jcfg)
    state = convert.train_state_from_arrays(params, jstate.opt, tcfg, "cpu")
    assert state.model.embed.table.dtype == torch.bfloat16
    step = tloop.make_train_step(tcfg, _tc(microbatch=mb))
    for i, batch in enumerate(_batches(tcfg, 5)):
        jstate, jm = jstep(jstate, *_args(batch, "jax"))
        state, tm = step(state, *_args(batch, "torch"))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2.0 ** -7, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2.0 ** -7,
                                   err_msg=f"step {i}")


def test_microbatch_equivalence_and_jax():
    """tests/test_train.py::TestMicrobatch on the port (microbatch 4 against
    1: loss rtol 1e-5, parameters rtol 3e-3 / atol 3e-5), and the port's
    microbatch 4 against the JAX package's with the same bounds."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (8, 32)).astype(np.int32)
    mask = np.ones((8, 32), np.float32)
    params = jtfm.init_params(jax.random.PRNGKey(0), JTINY)
    out = {}
    for mb in (1, 4):
        state = convert.train_state_from_arrays(params, jopt.init(params),
                                                TINY, "cpu")
        step = tloop.make_train_step(TINY, TrainConfig(
            microbatch=mb, warmup_steps=0, total_steps=100))
        s2, m = step(state, *(torch.from_numpy(a) for a in
                              (tokens, tokens, mask)))
        out[mb] = (convert.lm_arrays_from_params(s2.model), float(m["loss"]))
    jstep = jax.jit(jloop.make_train_step(JTINY, JTrainConfig(
        microbatch=4, warmup_steps=0, total_steps=100)))
    js, jm = jstep(_jax_state(params, JTINY), *(jnp.asarray(a) for a in
                                                 (tokens, tokens, mask)))
    np.testing.assert_allclose(out[1][1], out[4][1], rtol=1e-5)
    np.testing.assert_allclose(out[4][1], float(jm["loss"]), rtol=1e-5)
    for got, want in ((out[4][0], out[1][0]), (out[4][0], js.params)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=3e-3, atol=3e-5)


def test_microbatch_accumulates_in_float32(monkeypatch):
    """With microbatches the gradient reaching AdamW is the float32 sum of
    each microbatch's gradient / mb, not a bf16 ``.grad`` accumulation."""
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    batch = _batches(cfg, 1, batch=4, seq=16)[0]
    args = _args(batch, "torch")
    seen = {}

    def spy(grads, state, params, tc):
        seen.update({n: g.clone() for n, g in grads.items()})
        return real(grads, state, params, tc)

    state = tloop.init_state(0, cfg, device="cpu")
    want = {n: torch.zeros(p.shape) for n, p in state.params.items()}
    for i in range(2):
        m = ttfm.init_params(0, cfg, device="cpu")
        part = slice(2 * i, 2 * i + 2)
        loss, _ = ttfm.loss_fn(m, *(a[part] for a in args))
        loss.backward()
        for n, p in m.named_parameters():
            want[n] += p.grad.float() / 2
    real = topt.apply
    monkeypatch.setattr(topt, "apply", spy)
    tloop.make_train_step(cfg, TrainConfig(microbatch=2))(state, *args)
    for n, g in want.items():
        assert seen[n].dtype == torch.float32
        assert torch.equal(seen[n], g), n
    assert all(p.grad is None for p in state.params.values())


def test_loss_decreases_markov():
    """tests/test_train.py::TestEndToEnd on the port: the tiny model learns
    the Markov structure (last < first - 0.5 within 60 steps)."""
    src = tdata.MarkovZipfSource(tdata.LMDataConfig(
        vocab_size=256, seq_len=32, batch_size=8, branching=2))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=5, total_steps=60)
    state = tloop.init_state(0, TINY, device="cpu")
    state, hist = tloop.fit(state, src.batches(60), TINY, tc, log_every=5,
                            **QUIET)
    assert [h["step"] for h in hist] == list(range(0, 60, 5))
    assert set(hist[0]) == {"loss", "xent", "aux", "lr", "grad_norm", "step",
                            "elapsed_s"}
    first = hist[0]["loss"]
    last = min(h["loss"] for h in hist[-3:])
    assert last < first - 0.5, (first, last)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


def assert_state_specs_match(jcfg, tcfg, layout):
    """``loop.state_specs`` of a rank's model (on the meta device) against
    the JAX ``state_specs`` of the same config on ``layout``: each layer's
    leaf takes its ``[L, ...]`` stack's spec without the stack dim, and
    where the stack's ZeRO dim is ``L`` itself the layer's moments keep
    the parameter's spec."""
    from repro.sharding import specs as jspecs
    from repro_torch.launch.mesh import ctx_for

    jctx = jspecs.MeshCtx(layout, ("data",), "model")
    tctx = ctx_for(layout)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg, jctx),
                            jax.random.PRNGKey(0))
    want = jloop.state_specs(jloop.TrainState(shapes, None), jctx)
    model = ttfm.Transformer(tcfg, tctx, device="meta", rank=0)
    got = tloop.state_specs(tloop.TrainState(model, None), tctx)
    assert tuple(got["opt"].step) == tuple(want.opt.step) == ()
    flat = {"params": _flat(want.params), "opt": _flat(want.opt.m)}

    def pad(spec, nd):
        return tuple(spec) + (None,) * (nd - len(spec))

    for leaf, p in model.named_parameters():
        nd = p.dim()
        parts = leaf.split(".")
        stacked = parts[0] in convert.LAYER_STACKS
        assert got["opt"].v[leaf] == got["opt"].m[leaf]
        for kind, mine in (("params", got["params"][leaf]),
                           ("opt", got["opt"].m[leaf])):
            if not stacked:
                ref = pad(flat[kind][leaf.replace(".", "/")], nd)
            else:
                ref = pad(flat[kind]["/".join([parts[0]] + parts[2:])],
                          nd + 1)
                if ref[0] is not None:         # the stack's L is split
                    assert kind == "opt", leaf
                    ref = (None,) + pad(got["params"][leaf], nd)
                ref = ref[1:]
            assert pad(mine, nd) == ref, (tcfg.name, kind, leaf)


def test_state_specs_and_jit_step_single_only():
    """On one device every spec is ``P()``; on a 2 x 2 layout the specs
    are the JAX ``state_specs`` (``assert_state_specs_match``), and
    ``jit_train_step`` builds a step for a mesh context too."""
    from repro_torch.launch.mesh import MeshLayout, ctx_for

    state = tloop.init_state(0, TINY, device="cpu")
    specs = tloop.state_specs(state)
    assert set(specs["params"]) == set(state.params)
    assert all(s == () for s in specs["opt"].m.values())
    assert callable(tloop.jit_train_step(TINY, TrainConfig(), tloop.SINGLE,
                                         state))
    assert_state_specs_match(JTINY, TINY, MeshLayout(2, 2))
    assert callable(tloop.jit_train_step(
        TINY, TrainConfig(), ctx_for(MeshLayout(2, 2)), state))


# ---------------------------------------------------------------------------
# Converters and checkpoints
# ---------------------------------------------------------------------------

def test_bf16_checkpoint_bytes_equal_jax(tmp_path):
    """A bf16 model's npz through the port equals the JAX package's
    ``checkpoint.save`` of the same parameters, byte for byte."""
    jcfg = dataclasses.replace(jreg.smoke_variant("gemma3-4b"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(treg.smoke_variant("gemma3-4b"),
                               dtype="bfloat16")
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_arrays(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    from repro_torch.train import checkpoint as tckpt
    tckpt.save(tpath, convert.lm_arrays_from_params(model))
    jckpt.save(jpath, params)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()


def test_train_state_from_arrays_carries_moments():
    params = jtfm.init_params(jax.random.PRNGKey(1), JTINY)
    rng = np.random.default_rng(0)
    st = jopt.init(params)
    st = jopt.AdamWState(
        jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), st.m),
        jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), st.v),
        jnp.int32(7))
    state = convert.train_state_from_arrays(params, st, TINY, "cpu")
    assert int(state.opt.step) == 7 and state.opt.step.dtype == torch.int32
    for tree, got in ((st.m, state.opt.m), (st.v, state.opt.v)):
        back = convert.lm_arrays_from_params(got)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_launcher_npz_restores_in_jax(tmp_path, capsys):
    """``launch.train --smoke --device cpu`` writes the history and the
    final npz; the JAX package's ``checkpoint.restore`` reads the npz back
    equal to the port's final parameters, bitwise."""
    res = tlaunch.main(["--arch", "glm4-9b", "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--device", "cpu",
                        "--log-every", "1", "--out", str(tmp_path)])
    assert "[train] loss" in capsys.readouterr().out
    name = res.cfg.name
    assert (tmp_path / f"{name}_history.json").exists()
    assert [h["step"] for h in res.history] == [0, 1, 2]
    like = jtfm.init_params(jax.random.PRNGKey(0),
                            jreg.smoke_variant("glm4-9b"))
    got = jckpt.restore(str(tmp_path / f"{name}_final.npz"), like)
    want = convert.lm_arrays_from_params(res.state.model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launcher_batches_equal_jax_launcher_data():
    """The launcher's source is the JAX launcher's, seed for seed."""
    cfg = treg.smoke_variant("yi-6b")
    kw = dict(vocab_size=cfg.vocab_size, seq_len=16, batch_size=2, seed=3)
    a = next(tdata.MarkovZipfSource(tdata.LMDataConfig(**kw)).batches(1))
    b = next(jdata.MarkovZipfSource(jdata.LMDataConfig(**kw)).batches(1))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("argv,what", [
    (["--mesh", "pod", "--device", "cpu"], "no host counterpart"),
    (["--smoke", "--device", "cuda"], "--device cpu")])
def test_launcher_refusals_exit_2(argv, what):
    """``--mesh pod`` (the reference's TPU pod) says that layout has no
    host counterpart; without a card ``--device cuda`` names ``--device
    cpu`` (the cuda case runs only where there is no card)."""
    if "cuda" in argv and torch.cuda.is_available():
        argv = ["--mesh", "pod"]
        what = "no host counterpart"
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv], capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT), env={"PYTHONPATH": str(ROOT / "src"),
                                             "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2, out.stderr
    assert what in out.stderr


def test_launcher_mesh_host_npz_matches_one_device(tmp_path):
    """``launch.train --mesh host --devices 4 --mesh-model 2 --device cpu``
    exits 0 and writes an npz that the JAX package's ``checkpoint.restore``
    reads, equal to ``--mesh none``'s within rtol 1e-4 and atol 1e-5 of
    each leaf's largest (plus 2 lr where a step's update took the other
    sign of a near-zero gradient, at most 2 % of a leaf)."""
    argv = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--steps",
            "3", "--batch", "4", "--seq", "16", "--log-every", "1"]
    outs, logs = {}, {}
    for mesh in ("host", "none"):
        out = tmp_path / mesh
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--mesh", mesh, "--devices", "4", "--mesh-model", "2",
             "--out", str(out)], capture_output=True, text=True, timeout=300,
            cwd=str(ROOT), env={"PYTHONPATH": str(ROOT / "src"),
                                "PATH": "/usr/bin:/bin"})
        assert res.returncode == 0, res.stderr[-3000:]
        outs[mesh] = out / "smoke-gemma3-4b_final.npz"
        logs[mesh] = res.stdout
    assert "[train] mesh 2 x 2 over gloo (4 ranks)" in logs["host"]
    like = jtfm.init_params(jax.random.PRNGKey(0),
                            jreg.smoke_variant("gemma3-4b"))
    got, want = (jckpt.restore(str(outs[m]), like) for m in ("host", "none"))
    lr = 3e-4
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        tol = 1e-5 * float(np.abs(b).max()) + 1e-4 * np.abs(b)
        bad = np.abs(a - b) > tol
        assert not (np.abs(a - b) > tol + 2 * lr).any(), path
        assert bad.mean() <= 0.02, (path, float(bad.mean()))


# ---------------------------------------------------------------------------
# The deprecated LDA shims
# ---------------------------------------------------------------------------

def test_fit_lda_shims_warn_and_delegate(tiny_corpus, tmp_path):
    cfg = tlda.LDAConfig(num_topics=6, vocab_size=tiny_corpus.vocab_size,
                         block_tokens=256, num_shards=2)
    state = tlda.init_state(jrng.PRNGKey(9), torch.from_numpy(tiny_corpus.w),
                            torch.from_numpy(tiny_corpus.d),
                            tiny_corpus.num_docs, cfg)
    ec = texec.ExecConfig()
    with pytest.warns(DeprecationWarning, match="fit_lda is deprecated"):
        got, _, _ = tloop.fit_lda(state, jrng.PRNGKey(1), cfg, ec, 2,
                                  eval_every=0, **QUIET)
    want, _, _ = tsession.memory_fit(state, jrng.PRNGKey(1), cfg, ec, 2,
                                     eval_every=0, **QUIET)
    assert torch.equal(got.z, want.z)

    path = str(tmp_path / "s")
    tstream.write_sharded(path, tiny_corpus, tokens_per_shard=1024)
    with pytest.warns(DeprecationWarning, match="fit_lda_stream"):
        nwa, nka, _, _ = tloop.fit_lda_stream(
            tstream.ShardedCorpusReader(path), cfg, ec, 1, seed=5,
            device="cpu", **QUIET)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        nwb, nkb, _, _ = tsession.stream_fit(
            tstream.ShardedCorpusReader(path), cfg, ec, 1, seed=5,
            device="cpu", **QUIET)
    assert torch.equal(nwa.value, nwb.value) and torch.equal(nka.value,
                                                             nkb.value)
    assert tloop.init_stream is tsession.init_stream
    assert tloop.stream_init_key is tsession.stream_init_key
    assert tloop.stream_sweep_key is tsession.stream_sweep_key
