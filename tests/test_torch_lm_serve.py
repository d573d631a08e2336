"""The LM serving engine and launcher in the port against the JAX
package's, on the CPU, with carried weights: greedy generation equal to
the JAX ``Engine``'s, the twins of tests/test_serve.py, the temperature
path's key schedule and Gumbel noise, and ``launch.serve``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.models import transformer as jtfm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import convert
from repro_torch import rng as trng
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as serve_launch
from repro_torch.models import transformer as ttfm
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = Path(__file__).resolve().parents[1]
# the logits' tolerance (float32 on both sides, another summation order)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = jreg.smoke_variant("yi-6b"), treg.smoke_variant("yi-6b")
    params = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.lm_params_from_arrays(params, tcfg, device="cpu")
    return jcfg, tcfg, params, model


def _prompts(b, s, vocab, seed=1):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, s), 0,
                                       vocab, dtype=jnp.int32))


def test_greedy_matches_the_jax_engine(carried):
    """Tokens equal the JAX Engine's.  A step whose JAX top-2 margin is
    under the logits' tolerance may pick either token; such steps are
    counted and reported, and the sequences compared up to the first."""
    jcfg, tcfg, params, model = carried
    prompts = _prompts(3, 16, jcfg.vocab_size)
    n = 12
    want = np.asarray(JEngine(params, jcfg, JServeConfig(max_seq=40))
                      .generate(jnp.asarray(prompts), n))
    got = Engine(model, ServeConfig(max_seq=40)).generate(
        torch.from_numpy(prompts), n).numpy()
    # the JAX margins along its own sequences (teacher forcing)
    seq = np.concatenate([prompts, want], axis=1)
    logits, _, _ = jtfm.forward(params, jnp.asarray(seq), jcfg, remat=False)
    lay = jtfm.vocab_layout(jcfg, jtfm.SINGLE)
    lp = np.asarray(logits[:, 15:15 + n])
    lp = lp[..., np.asarray(lay.cyclic.to_logical(
        jnp.arange(lay.pad_rows))) < jcfg.vocab_size]
    top2 = np.sort(lp, axis=-1)[..., -2:]
    near = (top2[..., 1] - top2[..., 0]) < 2 * (ATOL + RTOL * np.abs(
        top2[..., 1]))
    print(f"near ties (JAX top-2 margin under the tolerance): "
          f"{int(near.sum())} of {near.size} steps")
    for row in range(prompts.shape[0]):
        ties = np.flatnonzero(near[row])
        upto = ties[0] if ties.size else n
        np.testing.assert_array_equal(got[row, :upto], want[row, :upto])
    assert got.shape == want.shape and got.dtype == np.int32


def test_greedy_matches_teacher_forcing(carried):
    """Greedy generation agrees with the full forward over the generated
    prefix (cache correctness through multiple decode steps)."""
    _, tcfg, _, model = carried
    eng = Engine(model, ServeConfig(max_seq=48))
    prompts = torch.from_numpy(_prompts(2, 16, tcfg.vocab_size))
    gen = eng.generate(prompts, 8)
    assert gen.shape == (2, 8)
    seq = torch.cat([prompts, gen], dim=1)
    with torch.no_grad():
        logits, _, _ = ttfm.forward(model, seq)
    lay = model.layout
    for t in range(8):
        lp = logits[:, 16 + t - 1]
        lp = torch.where(lay.valid_columns(), lp, -torch.inf) \
            if lay.valid_columns() is not None else lp
        expect = lay.cyclic.to_logical(lp.argmax(-1))
        np.testing.assert_array_equal(expect.numpy(), seq[:, 16 + t].numpy(),
                                      f"step {t}")


def test_generation_deterministic(carried):
    _, _, _, model = carried
    eng = Engine(model, ServeConfig(max_seq=40))
    prompts = torch.ones((1, 8), dtype=torch.int32)
    np.testing.assert_array_equal(eng.generate(prompts, 8).numpy(),
                                  eng.generate(prompts, 8).numpy())


def test_temperature_sampling_in_range(carried):
    _, tcfg, _, model = carried
    eng = Engine(model, ServeConfig(max_seq=40, temperature=1.0))
    out = eng.generate(torch.ones((2, 8), dtype=torch.int32), 8).numpy()
    assert out.min() >= 0 and out.max() < tcfg.vocab_size


def test_gumbel_noise_matches_jax():
    """The uniform under the noise is jax's bitwise; the noise itself is
    within 1e-6 (PyTorch's log against XLA's: measured 4.8e-7 at most)."""
    for seed in (0, 7, 123):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.gumbel(key, (4, 1000)))
        tiny = np.finfo(np.float32).tiny
        u = np.asarray(jax.random.uniform(key, (4, 1000), minval=tiny,
                                          maxval=1.0))
        tkey = trng.PRNGKey(seed)
        np.testing.assert_array_equal(
            torch.clamp(trng.uniform(tkey, (4, 1000)), min=tiny).numpy(), u)
        np.testing.assert_allclose(trng.gumbel(tkey, (4, 1000)).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


def test_temperature_sample_matches_jax_categorical(carried):
    """The engine's key schedule and sample against the JAX engine's: the
    same keys, and the same tokens except where two noisy logits lie
    within the noise's tolerance (counted)."""
    jcfg, tcfg, params, model = carried
    jeng = JEngine(params, jcfg, JServeConfig(max_seq=40, temperature=0.7))
    teng = Engine(model, ServeConfig(max_seq=40, temperature=0.7))
    lay = jtfm.vocab_layout(jcfg, jtfm.SINGLE)
    jkey, tkey = jax.random.PRNGKey(3), trng.PRNGKey(3)
    logits = np.random.default_rng(4).standard_normal(
        (6, lay.pad_rows)).astype(np.float32) * 3
    close = 0
    for _ in range(5):
        jkey, jsub = jax.random.split(jkey)
        tkey, tsub = trng.split(tkey)
        np.testing.assert_array_equal(tsub.numpy(),
                                      np.asarray(jsub).astype(np.int64))
        want = np.asarray(jeng._sample(jnp.asarray(logits), jsub))
        got = teng.sample(torch.from_numpy(logits), tsub).numpy()
        noisy = logits / 0.7 + trng.gumbel(tsub, logits.shape).numpy()
        top2 = np.sort(noisy, axis=-1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] < 1e-5
        close += int(tie.sum())
        np.testing.assert_array_equal(got[~tie], want[~tie])
    print(f"noisy near ties: {close}")


def test_launcher_smoke_on_cpu(capsys):
    res = serve_launch.main(["--arch", "gemma3-4b", "--smoke", "--batch", "2",
                             "--prompt-len", "12", "--gen", "6",
                             "--device", "cpu"])
    assert tuple(res.out.shape) == (2, 6)
    assert res.engine.scfg.max_seq == 12 + 6 + 1
    cfg = res.engine.cfg
    assert cfg.name == "smoke-gemma3-4b"
    assert int(res.out.min()) >= 0 and int(res.out.max()) < cfg.vocab_size
    # the prompts are the JAX launcher's for the seed, bitwise
    np.testing.assert_array_equal(
        res.prompts.numpy(),
        np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, 12), 0,
                                      cfg.vocab_size, dtype=jnp.int32)))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] smoke-gemma3-4b: generated (2, 6) "
                               "tokens in ")
    assert lines[1] == "[serve] sample: " + str(res.out[0].tolist())


def test_launcher_cross_attention_arch_and_depth_cut():
    res = serve_launch.main(["--arch", "musicgen-medium", "--smoke",
                             "--batch", "1", "--prompt-len", "5", "--gen",
                             "3", "--device", "cpu", "--layers", "3",
                             "--temperature", "0.5"])
    assert res.engine.cfg.num_layers == 3 and len(res.engine.model.blocks) == 3
    assert res.cond.shape == (1, res.engine.cfg.cond_len,
                              res.engine.cfg.cond_dim_)
    assert tuple(res.out.shape) == (1, 3)


def _run(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(ROOT))


def test_launcher_exits_2_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    out = _run(["--smoke", "--gen", "2"])
    assert out.returncode == 2
    assert "--device cpu" in out.stderr and out.stdout == ""


def _tokens(out) -> list:
    assert out.returncode == 0, out.stderr[-3000:]
    return [l for l in out.stdout.splitlines()
            if l.startswith("[serve] sample:")]


SERVE = ["--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "12",
         "--gen", "8"]


def test_launcher_mesh_host_prints_the_single_device_tokens():
    """``--mesh host`` on the CPU is a mesh of one rank: the same tokens
    as ``--mesh none``."""
    want = _tokens(_run(SERVE))
    out = _run(SERVE + ["--mesh", "host"])
    assert _tokens(out) == want and want
    assert "[serve] mesh 1 x 1 over gloo (1 ranks)" in out.stdout


def test_launcher_mesh_of_four_ranks_prints_the_same_tokens():
    """``--devices 4 --mesh-model 2``: 4 rank processes (data 2 x model 2,
    gloo) serve the same greedy tokens as one device."""
    want = _tokens(_run(SERVE))
    out = _run(SERVE + ["--mesh", "host", "--devices", "4", "--mesh-model",
                        "2"])
    assert _tokens(out) == want
    assert "[serve] mesh 2 x 2 over gloo (4 ranks)" in out.stdout


@pytest.mark.parametrize("args", [
    ["--mesh", "pod"], ["--mesh", "multipod"]])
def test_launcher_refuses_what_the_port_does_not_serve_on_a_mesh(args):
    """The reference's TPU pods exit 2: that layout has no host
    counterpart, and the message points at the dry run's per-rank
    bytes."""
    out = _run(["--smoke", "--device", "cpu", *args])
    assert out.returncode == 2
    assert "no host counterpart" in out.stderr and out.stdout == ""
    assert "repro_torch.launch.dryrun" in out.stderr


@pytest.mark.parametrize("args", [
    ["--arch", "mamba2-370m", "--mesh", "host", "--devices", "2",
     "--mesh-model", "2"],
    ["--arch", "hymba-1.5b", "--mesh", "host", "--devices", "4",
     "--mesh-model", "2"]])
def test_launcher_serves_the_ssm_families_on_a_model_axis(args):
    """The SSM families on a model axis above 1 (the mixer split by
    heads) serve ``--mesh none``'s greedy tokens."""
    arch = args[:2]
    want = _tokens(_run(SERVE + ["--seed", "3", *arch]))
    out = _run(SERVE + ["--seed", "3", *args])
    assert _tokens(out) == want and want
