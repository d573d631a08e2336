"""Serving a batch smaller than the data axis (long_500k's shape) on a
mesh of gloo ranks, its attention caches sequence-sharded over the data
ranks, against the JAX package's single device.

The smoke variants of gemma3-4b (its windows overridden to 4 and a global
layer, so that a window's live range sits inside one rank's block),
deepseek-v2-lite-16b (MLA's latent cache; capacity factor 16, so that no
(token, expert) pair drops), hymba-1.5b (attention beside the SSM) and
mamba2-370m (nothing to shard but its replicated state) are carried from
the JAX ``init_params`` (constant leaves perturbed) into each rank's
blocks.  Batch 1 on data 2 x model 1, data 2 x model 2 and data 4 x model
1, and batch 2 on data 4: the prompt's logits and 8 teacher-forced decode
steps whose positions cross a block boundary (a cache of 32 slots) within
rtol 1e-5 and atol 1e-6 of the row's largest logit of the JAX package's
``forward`` and ``decode_step``, the same bits on every rank; and
``Engine.generate``'s greedy tokens, in a cache of 21 slots that does not
split over the data axis (padded, as a ``NamedSharding`` pads), equal to
the JAX ``Engine.generate``'s and the same on every rank.  One spawn of
ranks per mesh serves every case.
"""
import dataclasses
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
from repro_torch.configs import registry as treg
from repro_torch.launch.mesh import MeshLayout, ctx_for
from repro_torch.models import transformer as ttfm
from test_torch_lm_mesh_train import _perturb

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma3-4b", "deepseek-v2-lite-16b", "hymba-1.5b", "mamba2-370m"]
MESHES = {"2x1": (2, 1), "2x2": (2, 2), "4x1": (4, 1)}
SP, STEPS, SLOTS = 12, 8, 32      # prompt, decode steps, the logits' cache
GEN, MAX_SEQ = 8, 21              # generate: tokens, its cache (padded)
RTOL, ATOL = 1e-5, 1e-6           # atol: of the row's largest |logit|


def _cfgs(name):
    over = {}
    if name == "gemma3-4b":
        over["window_pattern"] = (4, 0)   # layer 0 window 4, 1 global
    if name == "hymba-1.5b":
        over["window_pattern"] = (4,)         # layer 0 global (its ids)
    if jreg.get(name).num_experts:
        over["capacity_factor"] = 16.0
    return (dataclasses.replace(jreg.smoke_variant(name), **over),
            dataclasses.replace(treg.smoke_variant(name), **over))


def _batches(mesh):
    """The batch sizes a mesh serves below its data axis."""
    return (1, 2) if MESHES[mesh][0] == 4 else (1,)


def _jax_case(name):
    """The JAX package's single device, for batches of 1 and 2: the
    teacher-forced logits and ``Engine.generate``'s greedy tokens."""
    jcfg, _ = _cfgs(name)
    params = _perturb(jtfm.init_params(jax.random.PRNGKey(0), jcfg), 1)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, SP + STEPS)).astype(
        np.int32)
    full, _, caches = jtfm.forward(params, jnp.asarray(tokens[:, :SP]), jcfg,
                                   want_cache=True, remat=False)

    def grow(path, a):
        if str(path[-1].key) in ttfm.SEQ_LEAVES:
            widths = [(0, 0)] * a.ndim
            widths[2] = (0, STEPS)
            return jnp.pad(a, widths)
        return a

    caches = jax.tree_util.tree_map_with_path(grow, caches)
    rows = [np.asarray(full)]
    step = jax.jit(lambda p, t, c, i: jtfm.decode_step(p, t, c, i, jcfg))
    for i in range(SP, SP + STEPS):
        lg, caches = step(params, jnp.asarray(tokens[:, i]), caches,
                          jnp.int32(i))
        rows.append(np.asarray(lg)[:, None])
    eng = JEngine(params, jcfg, JServeConfig(max_seq=MAX_SEQ))
    gen = {b: np.asarray(eng.generate(jnp.asarray(tokens[:b, :SP]), GEN))
           for b in (1, 2)}
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "logits": np.concatenate(rows, axis=1), "generate": gen}


@pytest.fixture(scope="module")
def jax_refs():
    return {name: _jax_case(name) for name in ARCHS}


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_results(request, jax_refs):
    """Every arch at every batch below the data axis on one mesh: every
    rank's logits (logical vocab order) and generated tokens."""
    from repro_torch.serve.mesh_worker import LMMeshRun

    data, model = MESHES[request.param]
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the helpers' thread count
    try:
        with LMMeshRun({"data": data, "model": model}, torch.device("cpu"),
                       timeout_s=120) as run:
            for name in ARCHS:
                ref = jax_refs[name]
                _, tcfg = _cfgs(name)
                lay = ttfm.vocab_layout(tcfg,
                                        ctx_for(MeshLayout(data, model)))
                phys = torch.as_tensor(lay.to_physical(
                    torch.arange(tcfg.vocab_size)))
                run.call("load", tcfg, params=ref["params"],
                         max_seq=MAX_SEQ)
                for b in _batches(request.param):
                    tok = torch.from_numpy(ref["tokens"][:b])
                    res = run.call("logits", tok, STEPS, max_seq=SLOTS,
                                   per_rank=True)
                    gen = run.call("generate_ranks", tok[:, :SP], GEN)
                    out[name, b] = {
                        "logits": [r[..., phys].numpy()
                                   for r in res["rank_logits"]],
                        "generate": [g.numpy() for g in gen]}
    finally:
        torch.set_num_threads(threads)
    return request.param, out


@pytest.mark.parametrize("name", ARCHS)
def test_sequence_sharded_logits_match_jax_single_device(mesh_results,
                                                         jax_refs, name):
    mesh, out = mesh_results
    for b in _batches(mesh):
        got = out[name, b]["logits"]
        want = jax_refs[name]["logits"][:b]
        for r in got[1:]:
            np.testing.assert_array_equal(r, got[0], err_msg=(mesh, name, b))
        assert got[0].shape == want.shape, (mesh, name, b)
        scale = np.abs(want).max(-1, keepdims=True)
        err = np.abs(got[0] - want) - RTOL * np.abs(want) - ATOL * scale
        assert float(err.max()) <= 0.0, (mesh, name, b, float(
            (np.abs(got[0] - want) / scale).max()))


@pytest.mark.parametrize("name", ARCHS)
def test_sequence_sharded_generate_equals_jax_engine(mesh_results, jax_refs,
                                                     name):
    mesh, out = mesh_results
    for b in _batches(mesh):
        for r in out[name, b]["generate"]:
            np.testing.assert_array_equal(r, jax_refs[name]["generate"][b],
                                          err_msg=(mesh, name, b))


def test_sequence_sharded_cache_shapes_and_live_blocks():
    """A batch below the data axis: each data rank's attention and MLA
    leaves hold ``ceil(slots / dp)`` slots (padded), the SSM state whole;
    ``seq_block`` clips a live range to a rank's block (empty where it
    lies in another rank's)."""
    from repro_torch.models import attention as att

    gemma = treg.get("gemma3-4b")
    ctx = ctx_for(MeshLayout(2, 2))
    sh = ttfm.cache_shapes(gemma, 1, 131_072, ctx, seq_shard=True)
    assert sh["main"]["k"][0] == (34, 1, 65_536, 2, 256)
    ds = treg.get("deepseek-v2-lite-16b")
    sh = ttfm.cache_shapes(ds, 1, 21, ctx_for(MeshLayout(4, 1)),
                           seq_shard=True)
    assert sh["main"]["ckv"][0] == (26, 1, 6, 512)
    assert sh["dense"]["krope"][0] == (1, 1, 6, 64)

    class Rank:
        def __init__(self, j):
            self.comm = type("C", (), {"data_idx": j})()

    cache = torch.zeros(1, 16)
    assert att.seq_block(cache, Rank(1), 12, 20) == (16, 16, 20)
    base, lo, hi = att.seq_block(cache, Rank(0), 17, 20)
    assert (base, lo, hi) == (0, 17, 17)      # no live slot on rank 0


def test_launcher_batch_one_on_a_data_axis_prints_the_single_device_tokens():
    """``launch.serve --mesh host --devices 2 --batch 1``: 2 rank
    processes (data 2 x model 1, gloo), the cache sequence-sharded, serve
    ``--mesh none``'s greedy tokens."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
             "--arch", "yi-6b", "--seed", "3", "--device", "cpu", "--batch",
             "1", "--prompt-len", "12", "--gen", "8", *extra],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-3000:]
        return out.stdout

    want = [l for l in run().splitlines() if l.startswith("[serve] sample:")]
    out = run("--mesh", "host", "--devices", "2")
    assert "[serve] mesh 2 x 1 over gloo (2 ranks)" in out
    assert [l for l in out.splitlines()
            if l.startswith("[serve] sample:")] == want and want
