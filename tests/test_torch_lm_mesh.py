"""LM serving on a mesh of gloo ranks against the JAX package's single
device, from the same logical weights.

The eight attention architectures' smoke variants (float32; the MoE ones
at capacity factor 16, where neither level of the expert-parallel path can
drop, and the drops are counted) are carried from the JAX ``init_params``
(constant leaves perturbed, so that gates and norm scales matter) into
each rank's blocks (``convert.lm_shard_from_arrays``) on meshes of data 2
x model 2 and data 1 x model 4; the prompt's full-sequence logits and 4
teacher-forced decode steps are held to the JAX package's ``forward`` and
``decode_step`` on one device within rtol 1e-5 and atol 1e-6 of the row's
largest logit.  One more case runs gemma3-4b's smoke variant with
``seq_parallel_attn=True`` (the sequence-parallel prefill; the smoke head
counts trigger it on their own only where ``model % kv != 0``).  One
spawn of 4 ranks per mesh serves every case.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.models import transformer as jtfm
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttfm
from repro_torch.launch.mesh import MeshLayout, ctx_for

ARCHS = [a for a in jreg.all_arch_names()
         if jreg.get(a).has_attention and jreg.get(a).ssm_state == 0]
CASES = ARCHS + ["seq-parallel"]
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, SP, STEPS = 2, 12, 4
RTOL, ATOL = 1e-5, 1e-6          # atol: of the row's largest |logit|


def _cfgs(case):
    name = "gemma3-4b" if case == "seq-parallel" else case
    over = {}
    if case == "seq-parallel":
        over["seq_parallel_attn"] = True
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


def _jax_case(case):
    """The JAX package's single-device logits: the prompt's every position,
    then STEPS decode steps fed the next tokens."""
    jcfg, _ = _cfgs(case)
    params = _perturb(jtfm.init_params(jax.random.PRNGKey(0), jcfg), 1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B, SP + STEPS)).astype(
        np.int32)
    cond = None
    if jcfg.cross_attn_mode:
        cond = rng.standard_normal((B, jcfg.cond_len, jcfg.cond_dim_)).astype(
            np.float32)
    jc = None if cond is None else jnp.asarray(cond)
    full, _, _ = jtfm.forward(params, jnp.asarray(tokens[:, :SP]), jcfg,
                              cond=jc, remat=False)
    _, caches = jtfm.prefill(params, jnp.asarray(tokens[:, :SP]), jcfg,
                             cond=jc)

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
                                      caches, jnp.int32(i), jcfg, cond=jc)
        rows.append(np.asarray(lg)[:, None])
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "cond": cond, "logits": np.concatenate(rows, axis=1)}


@pytest.fixture(scope="module")
def jax_refs():
    return {case: _jax_case(case) for case in CASES}


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_results(request, jax_refs):
    """Every case on one mesh of 4 gloo ranks: the logits (logical vocab
    order) and each MoE layer's drops."""
    from repro_torch.serve.mesh_worker import LMMeshRun

    data, model = MESHES[request.param]
    out = {}
    with LMMeshRun({"data": data, "model": model}, torch.device("cpu"),
                   timeout_s=120) as run:
        for case in CASES:
            ref = jax_refs[case]
            _, tcfg = _cfgs(case)
            run.call("load", tcfg, params=ref["params"])
            cond = None if ref["cond"] is None else torch.from_numpy(
                ref["cond"])
            res = run.call("logits", torch.from_numpy(ref["tokens"]), STEPS,
                           cond)
            lay = ttfm.vocab_layout(tcfg, ctx_for(MeshLayout(data, model)))
            phys = torch.as_tensor(lay.to_physical(
                torch.arange(tcfg.vocab_size)))
            out[case] = (res["logits"][..., phys].numpy(), res["drops"])
    return request.param, out


@pytest.mark.parametrize("case", CASES)
def test_mesh_logits_match_jax_single_device(mesh_results, jax_refs, case):
    mesh, out = mesh_results
    got, drops = out[case]
    want = jax_refs[case]["logits"]
    assert got.shape == want.shape, (mesh, case)
    scale = np.abs(want).max(-1, keepdims=True)
    err = np.abs(got - want) - RTOL * np.abs(want) - ATOL * scale
    assert float(err.max()) <= 0.0, (mesh, case, float(
        (np.abs(got - want) / scale).max()))
    assert all(d == 0 for d, _ in drops), (mesh, case, drops)
    if _cfgs(case)[1].num_experts:
        assert drops and all(n > 0 for _, n in drops)


def test_seq_parallel_rule_and_cache_heads():
    """Where the sequence-parallel prefill runs and what each rank's cache
    holds, from cfg and the mesh alone (the reference's condition)."""
    from repro_torch.models import attention as att
    from repro_torch.sharding.specs import MeshCtx

    class Live(MeshLayout):
        def all_reduce(self, *a, **k):       # a rank's mesh, for the rule
            raise AssertionError

    gemma = treg.get("gemma3-4b")            # kv = 4
    two, four = (ctx_for(Live(2, m)) for m in (2, 4))
    assert att.seq_parallel(gemma, two, 2048)          # 2 % 4 != 0
    assert not att.seq_parallel(gemma, four, 2048)     # 4 % 4 == 0
    assert not att.seq_parallel(gemma, two, 1)         # decode
    assert not att.seq_parallel(gemma, two, 2047)      # does not split
    assert not att.seq_parallel(gemma, ctx_for(MeshLayout(2, 2)), 2048)
    assert att.attn_split(gemma, 4) == "heads"
    assert att.cache_kv_heads(gemma, 2) == 2
    phi = treg.get("phi3-medium-14b")        # kv = 10
    assert att.attn_split(phi, 4) == "gather"
    assert att.cache_kv_heads(phi, 4) == 10
    ds = treg.get("deepseek-v2-lite-16b")    # MLA, 16 heads
    assert att.attn_split(ds, 4) == "heads"
    shapes = ttfm.cache_shapes(ds, 4, 100, four)
    assert shapes["main"]["ckv"][0] == (26, 4, 100, 512)
