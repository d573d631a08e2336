"""Every architecture's smoke variant in the port against the JAX
package's training side, on the CPU, from the same weights (the JAX
``init_params`` carried across, constant leaves perturbed): one
``loss_fn`` and its gradient against ``jax.value_and_grad``; the
rematerialised forward against the plain one; ``cond`` cut from the graph;
the parameter converters both ways."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.models import transformer as ttfm
from test_torch_lm_train import (ARCHS, TINY, _args, _batches, _setup)

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5      # atol: times the leaf's largest |g|


def _assert_tree_close(got, want, rtol, atol_rel, what=""):
    """Leaf by leaf: |got - want| <= atol_rel * max|want| + rtol |want|."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        w = np.asarray(w, np.float32)
        g = np.asarray(flat_g[path], np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol_rel * scale,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _route_margin(model, batch) -> float:
    """The smallest gap between the k-th and (k+1)-th router probability
    over every MoE layer's tokens (inf without MoE): a flipped route at a
    gap under the tolerance is a near tie, not a fault."""
    gaps = []

    def hook(mod, inp, out):
        x = inp[0].reshape(-1, inp[0].shape[-1])
        probs = torch.softmax(x.float() @ mod.router, -1)
        top = probs.topk(mod.cfg.top_k + 1, -1).values
        gaps.append(float((top[:, -2] - top[:, -1]).min()))

    from repro_torch.models.moe import MoE
    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, MoE)]
    with torch.no_grad():
        ttfm.loss_fn(model, *_args(batch, "torch"))
    for h in hs:
        h.remove()
    return min(gaps, default=float("inf"))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    """One loss_fn and its gradient from carried weights against
    ``jax.value_and_grad`` of the JAX loss_fn: loss rtol 1e-5, each
    gradient leaf rtol 1e-4 with atol 1e-5 x its largest |g|."""
    jcfg, tcfg, params = _setup(name)
    batch = _batches(tcfg, 1)[0]
    model = convert.lm_params_from_arrays(params, tcfg, device="cpu")

    def lf(p):
        return jtfm.loss_fn(p, *_args(batch, "jax")[:3], jcfg,
                            cond=(jnp.asarray(batch["cond"]) if "cond" in
                                  batch else None))

    (wl, wm), wg = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    loss, met = ttfm.loss_fn(model, *_args(batch, "torch"))
    loss.backward()
    loss, met = loss.detach(), {k: v.detach() for k, v in met.items()}
    np.testing.assert_allclose(float(loss), float(wl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["xent"]), float(wm["xent"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(met["aux"]), float(wm["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    grads = convert.lm_arrays_from_params(
        {n: p.grad for n, p in model.named_parameters()})
    try:
        _assert_tree_close(grads, wg, GRAD_RTOL, GRAD_ATOL, f"{name} ")
    except AssertionError as e:
        margin = _route_margin(model, batch)
        raise AssertionError(f"{e}\nsmallest top-k router gap {margin:.3g} "
                             f"({'a near tie' if margin < 1e-5 else 'no tie'}"
                             ")") from None


@pytest.mark.parametrize("name", ["gemma3-4b", "llama-3.2-vision-11b"])
def test_remat_equals_plain(name):
    """Checkpointed layers give the same loss and gradients, bitwise (the
    cross-attention layers are checkpointed too)."""
    _, tcfg, params = _setup(name)
    batch = _batches(tcfg, 1)[0]
    out = []
    for remat in (False, True):
        model = convert.lm_params_from_arrays(params, tcfg, device="cpu")
        loss, _ = ttfm.loss_fn(model, *_args(batch, "torch"), remat=remat)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


def test_remat_keeps_layer_inputs_only():
    """Under remat the forward saves each layer's input, not its
    activations: fewer saved bytes than without."""
    cfg = dataclasses.replace(TINY, num_layers=4, d_ff=512)
    model = ttfm.init_params(0, cfg, device="cpu")
    batch = _batches(cfg, 1, batch=2, seq=64)[0]
    saved = {}
    for remat in (False, True):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            ttfm.loss_fn(model, *_args(batch, "torch"), remat=remat)
        saved[remat] = total[0]
    assert saved[True] < saved[False] / 2, saved


def test_cache_refused_under_remat():
    cfg = dataclasses.replace(TINY, remat=True)
    model = ttfm.init_params(0, cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="remat"):
        model(tokens, caches=ttfm.allocate_cache(cfg, 1, 4, "cpu"))
    with torch.no_grad():       # no gradients recorded: nothing to remat
        model(tokens, caches=ttfm.allocate_cache(cfg, 1, 4, "cpu"))
    logits, _ = ttfm.prefill(model, tokens)
    assert logits.shape == (1, cfg.vocab_size)


def test_cond_gets_no_gradient():
    _, tcfg, params = _setup("llama-3.2-vision-11b")
    batch = _batches(tcfg, 1)[0]
    model = convert.lm_params_from_arrays(params, tcfg, device="cpu")
    args = _args(batch, "torch")
    args[3].requires_grad_(True)
    loss, _ = ttfm.loss_fn(model, *args)
    loss.backward()
    assert args[3].grad is None
    assert model.cross_blocks[0].attn_x.wk.grad is not None



@pytest.mark.parametrize("name", ARCHS)
def test_lm_arrays_round_trip(name):
    jcfg, tcfg, params = _setup(name)
    model = convert.lm_params_from_arrays(params, tcfg, device="cpu")
    back = convert.lm_arrays_from_params(model)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
