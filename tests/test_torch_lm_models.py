"""Every architecture's smoke variant in the port against the JAX package,
on the CPU, from the same weights (the JAX ``init_params`` carried across
by ``convert.lm_params_from_arrays``, its constant leaves perturbed so
that every norm scale, gate and mix is exercised): forward, prefill and
its cache, and 4 decode steps, logits within rtol 1e-4 / atol 1e-5.  Plus
the port's own twins of tests/test_models_smoke.py and the registry's
specs against the JAX registry's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttfm

ARCHS = jreg.all_arch_names()
B, S, STEPS = 2, 40, 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _perturb(params, seed):
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.reshape(-1)[0]):
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(f, params)


def _setup(name):
    jcfg, tcfg = jreg.smoke_variant(name), treg.smoke_variant(name)
    params = _perturb(jtfm.init_params(jax.random.PRNGKey(0), jcfg), 1)
    model = convert.lm_params_from_arrays(params, tcfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    cond = None
    if jcfg.cross_attn_mode:
        cond = rng.standard_normal((B, jcfg.cond_len, jcfg.cond_dim_)).astype(
            np.float32)
    return jcfg, tcfg, params, model, tokens, cond


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", ARCHS)
def test_converted_params_cover_the_model(name):
    """Every JAX leaf lands on a parameter of the same shape, and the two
    hold the same number of weights."""
    jcfg, tcfg, params, model, _, _ = _setup(name)
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    np.testing.assert_array_equal(model.embed.table.detach().numpy(),
                                  np.asarray(params["embed"]["table"]))
    blk = model.blocks[-1].ln1.scale.detach().numpy()
    np.testing.assert_array_equal(
        blk, np.asarray(params["blocks"]["ln1"]["scale"][-1]))


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_and_decode_match_jax(name):
    jcfg, tcfg, params, model, tokens, cond = _setup(name)
    want, waux, _ = jtfm.forward(params, jnp.asarray(tokens), jcfg,
                                 cond=_j(cond), remat=False)
    with torch.no_grad():
        got, gaux, _ = ttfm.forward(model, _t(tokens), _t(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(gaux), float(waux), **TOL)

    sp = S - STEPS
    wlast, wc = jtfm.prefill(params, jnp.asarray(tokens[:, :sp]), jcfg,
                             cond=_j(cond))
    with torch.no_grad():
        glast, gc = ttfm.prefill(model, _t(tokens[:, :sp]), _t(cond))
    np.testing.assert_allclose(glast.numpy(), np.asarray(wlast), **TOL)
    for stack, leaves in wc.items():
        for leaf, arr in leaves.items():
            np.testing.assert_allclose(gc[stack][leaf].numpy(),
                                       np.asarray(arr), err_msg=leaf, **TOL)

    def grow(path, a):
        if str(path[-1].key) in ttfm.SEQ_LEAVES:
            widths = [(0, 0)] * a.ndim
            widths[2] = (0, STEPS)
            return jnp.pad(a, widths)
        return a

    wc = jax.tree_util.tree_map_with_path(grow, wc)
    caches = ttfm.allocate_cache(tcfg, B, S, "cpu")
    with torch.no_grad():
        ttfm.prefill(model, _t(tokens[:, :sp]), _t(cond), caches)
    for i in range(sp, S):
        wl, wc = jtfm.decode_step(params, jnp.asarray(tokens[:, i]), wc,
                                  jnp.int32(i), jcfg, cond=_j(cond))
        with torch.no_grad():
            gl, _ = ttfm.decode_step(model, _t(tokens[:, i]), caches, i,
                                     _t(cond))
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl),
                                   err_msg=f"step {i}", **TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward(name):
    """Prefill S-1 tokens then decode the last one; the logits match the
    full forward at the final position (every cache kind)."""
    _, tcfg, _, model, tokens, cond = _setup(name)
    with torch.no_grad():
        full, _, _ = ttfm.forward(model, _t(tokens), _t(cond))
        caches = ttfm.allocate_cache(tcfg, B, S, "cpu")
        ttfm.prefill(model, _t(tokens[:, :S - 1]), _t(cond), caches)
        got, _ = ttfm.decode_step(model, _t(tokens[:, S - 1]), caches, S - 1,
                                  _t(cond))
    ref = full[:, -1]
    err = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    assert err < 2e-3, (name, err)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_shapes_and_finite(name):
    tcfg = treg.smoke_variant(name)
    model = ttfm.init_params(0, tcfg, device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (B, 16))
    cond = (torch.randn(B, tcfg.cond_len, tcfg.cond_dim_)
            if tcfg.cross_attn_mode else None)
    with torch.no_grad():
        logits, aux, _ = ttfm.forward(model, tokens, cond)
    assert logits.shape == (B, 16, ttfm.vocab_layout(tcfg).pad_rows)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("name", ARCHS)
def test_configs_and_param_count_match_jax(name):
    """The copied configs are the JAX package's, field for field, and so
    their parameter counts (which test_models_smoke.py bounds)."""
    jcfg, tcfg = jreg.get(name), treg.get(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(treg.smoke_variant(name)) == \
        dataclasses.asdict(jreg.smoke_variant(name))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    for shape in INPUT_SHAPES.values():
        assert treg.shape_supported(tcfg, shape) == \
            jreg.shape_supported(jcfg, shape)


def _spec_tree(specs):
    """The JAX registry's ShapeDtypeStruct tree as (shape, dtype name)."""
    if isinstance(specs, dict):
        return {k: _spec_tree(v) for k, v in specs.items()}
    if isinstance(specs, tuple):                 # the port's (shape, dtype)
        shape, dt = specs
        return (tuple(shape), str(dt).replace("torch.", ""))
    return (tuple(specs.shape), str(specs.dtype))


@pytest.mark.parametrize("name", ARCHS)
def test_registry_specs_match_jax(name):
    """cache_shapes and input_specs give the JAX registry's shapes and
    dtypes, at full size and for the smoke variant."""
    for cfgs in ((jreg.get(name), treg.get(name)),
                 (jreg.smoke_variant(name), treg.smoke_variant(name))):
        jcfg, tcfg = cfgs
        assert _spec_tree(treg.cache_shapes(tcfg, 4, 2177)) == \
            _spec_tree(jreg.cache_shapes(jcfg, 4, 2177))
        for shape in INPUT_SHAPES.values():
            assert _spec_tree(treg.input_specs(tcfg, shape)) == \
                _spec_tree(jreg.input_specs(jcfg, shape)), shape.name
        c = treg.cond_spec(tcfg, 3)
        jc = jreg.cond_spec(jcfg, 3)
        assert (c is None) == (jc is None)
        if c is not None:
            assert _spec_tree(c) == _spec_tree(jc)


@pytest.mark.parametrize("name", ARCHS)
def test_allocated_cache_follows_cache_shapes(name):
    tcfg = treg.smoke_variant(name)
    caches = ttfm.allocate_cache(tcfg, 3, 17, "cpu")
    spec = treg.cache_shapes(tcfg, 3, 17)
    assert {s: {k: (tuple(v.shape), v.dtype) for k, v in leaves.items()}
            for s, leaves in caches.items()} == \
        {s: {k: (tuple(sh), dt) for k, (sh, dt) in leaves.items()}
         for s, leaves in spec.items()}


def test_window_patterns():
    g = treg.get("gemma3-4b")
    wins = g.windows()
    assert wins[:6] == (1024,) * 5 + (0,)
    assert sum(w == 0 for w in wins) == 5   # 34 layers -> 5 globals
    h = treg.get("hymba-1.5b")
    wins = h.windows()
    assert wins[0] == 0 and wins[15] == 0 and wins[31] == 0
    assert sum(w == 0 for w in wins) == 3
    # gemma's global layers take the 1M RoPE base, the local ones 10k
    wins, thetas = ttfm.layer_meta(g, g.num_layers, 0)
    assert [i for i, t in enumerate(thetas) if t == 1e6] == [5, 11, 17, 23, 29]
    assert all(t == 1e4 for w, t in zip(wins, thetas) if w)


def test_layer_schedule_interleaves_cross_layers():
    """llama-vision: one cross layer before every group of self layers;
    deepseek: its dense-FFN layers first."""
    cfg = dataclasses.replace(treg.smoke_variant("llama-3.2-vision-11b"),
                              num_layers=6, cross_attn_group=2)
    model = ttfm.init_params(0, cfg, device="cpu")
    order = [(s, i) for s, i, _, _, _ in model.schedule()]
    assert order == [(None, 0), ("main", 0), ("main", 1), (None, 1),
                     ("main", 2), ("main", 3)]
    cfg = dataclasses.replace(treg.smoke_variant("deepseek-v2-lite-16b"),
                              num_layers=3)
    model = ttfm.init_params(0, cfg, device="cpu")
    assert [(s, i) for s, i, _, _, _ in model.schedule()] == \
        [("dense", 0), ("main", 0), ("main", 1)]
    assert ttfm.layer_plan(cfg) == jtfm.layer_plan(dataclasses.replace(
        jreg.smoke_variant("deepseek-v2-lite-16b"), num_layers=3))


def test_convert_refuses_a_wrong_dtype():
    jcfg, tcfg = jreg.smoke_variant("yi-6b"), treg.smoke_variant("yi-6b")
    params = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    params["final_norm"]["scale"] = params["final_norm"]["scale"].astype(
        np.float64)
    with pytest.raises(ValueError, match="final_norm.scale"):
        convert.lm_params_from_arrays(params, tcfg, device="cpu")


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttfm.init_params(0, treg.smoke_variant("yi-6b"))
