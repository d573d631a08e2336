"""LM serving on a mesh of ranks that share the card: the card's twins of
tests/test_torch_lm_mesh*.py.  Every test here needs a CUDA card and
skips without one; the file imports neither jax nor the JAX package, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_lm_mesh_cuda.py
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import rng
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MeshLayout, ctx_for
from repro_torch.models import transformer as tfm

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5          # card against card; atol of the row's largest


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks share it over gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _logical(logits, cfg, shape):
    lay = tfm.vocab_layout(cfg, ctx_for(MeshLayout(*shape)))
    return logits[..., torch.as_tensor(lay.to_physical(
        torch.arange(cfg.vocab_size)))]


def _single(cfg, seed, tokens, steps, device):
    model = tfm.init_params(seed, cfg, device=device)
    tok = tokens.to(device)
    sp = tok.shape[1] - steps
    caches = tfm.allocate_cache(cfg, tok.shape[0], tok.shape[1], device)
    with torch.no_grad():
        full, _ = model(tok[:, :sp], caches=caches, remat=False)
        outs = [full.float()]
        for i in range(steps):
            outs.append(model.decode_step(tok[:, sp + i], caches,
                                          sp + i).float()[:, None])
    return torch.cat(outs, dim=1).cpu()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v2-lite-16b"])
def test_mesh_on_the_card_equals_one_device(card, arch, shape):
    """A smoke arch (float32) on 4 gloo ranks sharing the card: the
    prompt's logits and 4 decode steps equal the single-device model of
    the same seed on the card."""
    from repro_torch.serve.mesh_worker import LMMeshRun

    cfg = registry.smoke_variant(arch)
    tokens = rng.randint(rng.PRNGKey(0), (4, 16), 0, cfg.vocab_size)
    with LMMeshRun({"data": shape[0], "model": shape[1]}, card) as run:
        assert run.transport == "gloo" or torch.cuda.device_count() >= 4
        run.call("load", cfg, seed=0, capacity_factor=16.0)
        res = run.call("logits", tokens, 4)
    got = _logical(res["logits"], cfg, shape)
    want = _single(cfg, 0, tokens, 4, card)
    scale = want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= RTOL * want.abs() + ATOL * scale)
                .all())


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_expert_parallel_layer_on_the_card_equals_its_emulation(card, cf):
    """The first MoE layer on 4 ranks sharing the card (the all-to-all
    staged through pinned host memory) against
    ``moe_block_spmd_emulated``: the routed rows bitwise, drops equal."""
    from repro_torch.serve.mesh_worker import LMMeshRun

    cfg = ModelConfig(name="t", arch_type="moe", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
                      num_experts=8, top_k=2, moe_d_ff=32,
                      num_shared_experts=1, capacity_factor=cf,
                      dtype="float32")
    with LMMeshRun({"data": 2, "model": 2}, card) as run:
        run.call("load", cfg, seed=3)
        got = [run.call("moe_check", shape, s) for s, shape in
               enumerate([(4, 6, 64), (2, 1, 64)])]
    for res in got:
        assert res["routed_equal"], res
        assert (res["dropped"], res["pairs"]) == (
            res["dropped_emulated"], res["pairs_emulated"]), res


def test_launcher_mesh_host_on_the_card_prints_the_same_tokens(card):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
             "--batch", "4", "--prompt-len", "12", "--gen", "8", *extra],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-3000:]
        return [l for l in out.stdout.splitlines()
                if l.startswith("[serve] sample:")]

    want = run()
    assert run("--mesh", "host") == want
    assert run("--mesh", "host", "--devices", "4", "--mesh-model",
               "2") == want


def _cpu_weights(cfg, seed):
    """A model's weights drawn on the CPU, its constant leaves perturbed
    (so that norm scales, gates and ``D`` matter), as the JAX layout's
    numpy pytree: what a mesh on the card and one CPU device both load."""
    from repro_torch import convert
    model = tfm.init_params(seed, cfg, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            flat = p.reshape(-1)
            if flat.numel() and bool((flat == flat[0]).all()):
                p.add_(0.3 * torch.randn(p.shape, generator=g).to(p))
    return model, convert.lm_arrays_from_params(model)


def _cpu_logits(model, tokens, steps):
    sp = tokens.shape[1] - steps
    caches = tfm.allocate_cache(model.cfg, tokens.shape[0], tokens.shape[1],
                                "cpu")
    with torch.no_grad():
        full, _ = model(tokens[:, :sp], caches=caches, remat=False)
        outs = [full.float()]
        for i in range(steps):
            outs.append(model.decode_step(tokens[:, sp + i], caches,
                                          sp + i).float()[:, None])
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("case", [("mamba2-370m", (1, 4), {}),
                                  ("gemma3-4b", (2, 1),
                                   {"window_pattern": (4, 0)})])
def test_ssm_and_sequence_sharded_mesh_on_the_card_equal_the_cpu(card,
                                                                  case):
    """A smoke SSM on 1 x 4 (its mixer split by heads), and a smoke
    gemma3-4b (a window of 4 and a global layer) serving a batch of 1 on 2
    x 1 with its caches sequence-sharded (32 slots, decode positions
    crossing the blocks' boundary), 4 gloo ranks sharing the card: the
    prompt's logits and 4 decode steps equal one CPU device's from the
    same weights (float32, rtol 1e-4, atol 1e-5 of the row's largest),
    every rank's the same bits."""
    from repro_torch.serve.mesh_worker import LMMeshRun

    arch, shape, over = case
    cfg = dataclasses.replace(registry.smoke_variant(arch), **over)
    model, params = _cpu_weights(cfg, 0)
    batch = 4 if shape[0] == 1 else 1
    tokens = rng.randint(rng.PRNGKey(0), (batch, 16), 0, cfg.vocab_size)
    with LMMeshRun({"data": shape[0], "model": shape[1]}, card) as run:
        run.call("load", cfg, params=params)
        res = run.call("logits", tokens, 4, max_seq=32, per_rank=True)
    ranks = res["rank_logits"]
    assert all(torch.equal(r, ranks[0]) for r in ranks[1:])
    got = _logical(res["logits"], cfg, shape)
    want = _cpu_logits(model, tokens, 4)
    scale = want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= RTOL * want.abs() + ATOL * scale)
                .all()), float(((got - want).abs() / scale).max())
