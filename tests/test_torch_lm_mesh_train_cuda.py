"""LM training on a mesh of ranks that share the card: the card's twins of
tests/test_torch_lm_mesh_train.py.  Every test here needs a CUDA card and
skips without one; the file imports neither jax nor the JAX package, so
it runs where only PyTorch is installed:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m cuda tests/test_torch_lm_mesh_train_cuda.py
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.models import transformer as tfm
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5   # atol: of the leaf's largest
TC = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                 microbatch=2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks share it over gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _flat(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in convert.flat_tree(tree).items()}


def _single(cfg, params, batch, device):
    """One device's step from ``params`` in its two halves: the loss, the
    metrics, and the gradient it applies and the state after it."""
    model = convert.lm_params_from_arrays(params, cfg, device=device)
    args = [torch.from_numpy(batch[k]).to(device)
            for k in ("tokens", "targets", "mask")]
    named = dict(model.named_parameters())
    state = loop.TrainState(model, opt.init(named))
    grads, met = loop.step_grads(state, TC.microbatch, *args)
    state, om = loop.apply_grads(state, grads, TC)
    return (float(met["loss"]), {k: float(v) for k, v in om.items()},
            {"grads": _flat(convert.lm_arrays_from_params(grads)),
             "params": _flat(convert.lm_arrays_from_params(model)),
             "m": _flat(convert.lm_arrays_from_params(state.opt.m)),
             "v": _flat(convert.lm_arrays_from_params(state.opt.v))})


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "gemma3-4b",
                                  "llama4-scout-17b-a16e"])
def test_mesh_train_step_on_the_card_equals_one_device(card, arch):
    """A smoke arch (float32, remat, capacity factor 16) on 4 gloo ranks
    (2 x 2) sharing the card: one step's loss, gradient (ZeRO slices
    gathered), moments and parameters equal the single-device step on
    the card (parameters: plus as much as the gradient's tolerance can
    move the first step, up to 2 lr, on at most 2 % of a leaf)."""
    from repro_torch.train.mesh_worker import LMTrainRun

    cfg = dataclasses.replace(registry.smoke_variant(arch), remat=True,
                              capacity_factor=16.0)
    model = tfm.init_params(0, cfg, device="cpu")
    params = convert.lm_arrays_from_params(model)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "mask": np.ones((4, 16), np.float32)}
    with LMTrainRun({"data": 2, "model": 2}, card) as run:
        run.call("train_init", cfg, TC, params=params)
        gm = run.call("train_grads", batch)
        got = run.arrays(cfg, "grads")
        met = run.call("train_apply")
        got = {k: _flat(v) for k, v in dict(
            got, **run.arrays(cfg, "params", "m", "v")).items()}
    loss, wmet, want = _single(cfg, params, batch, card)
    assert abs(gm["loss"] - loss) <= LOSS_RTOL * abs(loss)
    assert abs(met["grad_norm"] - wmet["grad_norm"]) <= \
        RTOL * wmet["grad_norm"]
    for kind in ("grads", "m", "v", "params"):
        for path, w in want[kind].items():
            g = got[kind][path]
            scale = float(np.abs(w).max())
            bad = np.abs(g - w) > ATOL * scale + RTOL * np.abs(w)
            if kind != "params":
                assert not bad.any(), (kind, path)
                continue
            # as far as the gradient's tolerance can move AdamW's first
            # step, lr * x / (|x| + eps) of the clipped gradient x
            clip = min(1.0, TC.grad_clip / wmet["grad_norm"])
            band = opt.first_step_band(
                torch.from_numpy(want["grads"][path]), clip, wmet["lr"],
                TC.eps, RTOL, ATOL).numpy()
            assert not (np.abs(g - w) > ATOL * scale + RTOL * np.abs(w)
                        + band).any(), path
            assert bad.mean() <= 0.02, path


def test_launcher_mesh_host_trains_on_the_card(card, tmp_path):
    """``launch.train --mesh host --devices 4 --mesh-model 2`` on the card
    exits 0, and its losses equal ``--mesh none``'s within rtol 1e-4."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "gemma3-4b", "--smoke", "--steps", "3", "--batch", "4",
             "--seq", "16", "--log-every", "1", "--out", "", *extra],
            capture_output=True, text=True, timeout=600, env=env,
            cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-3000:]
        return [float(l.split()[3]) for l in out.stdout.splitlines()
                if l.startswith("step ")]

    want = run()
    got = run("--mesh", "host", "--devices", "4", "--mesh-model", "2")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)
