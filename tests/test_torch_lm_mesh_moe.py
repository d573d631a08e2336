"""The expert-parallel MoE: the port's whole-mesh emulation against the JAX
package's ``moe_block`` on an Auto-axis data 2 x model 4 mesh, and the
port's ``moe_block_spmd`` on gloo ranks against the emulation.

The JAX side runs once per module, in a subprocess this file starts
(``python test_torch_lm_mesh_moe.py --jax-ref out.npz`` under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax is
imported), float32: the mesh path at capacity factors 8.0 (no drops) and
0.5 (drops), and the dense path, on one seeded input.  8 experts on 4
model ranks: expert ``e`` is the JAX stack's row ``(e mod 4) * 2 + e div
4`` on that mesh (the cyclic order), which the port's logical weights are
permuted from.  Held: at 8.0 the emulation within 2e-5 of the dense path
(of the largest output) and of JAX's mesh; at 0.5 drops occur and the
emulation matches JAX's mesh within 2e-5; the aux loss within 1e-6: the
emulation's ranks' own averaged against JAX's mesh, its whole batch's
(the port's mesh's) against the dense path.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
DP, M, E = 2, 4, 8
FACTORS = (8.0, 0.5)
SHAPE = (2, 32, 64)
TOL, AUX_TOL = 2e-5, 1e-6


def _cfg_kw(cf):
    return dict(name="t", arch_type="moe", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
                num_experts=E, top_k=2, moe_d_ff=32, num_shared_experts=1,
                capacity_factor=cf, dtype="float32")


def _jax_reference(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.base import ModelConfig
    from repro.models import moe
    from repro.sharding.specs import MeshCtx

    assert jax.device_count() == DP * M, jax.device_count()
    mesh = jax.make_mesh((DP, M), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    ctx = MeshCtx(mesh, ("data",), "model")
    params = moe.init_moe(jax.random.PRNGKey(0), ModelConfig(**_cfg_kw(1.0)))
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    res = {"x": x}
    for path, leaf in (("router", params["router"]),
                       ("shared/w_gate", params["shared"]["w_gate"]),
                       ("shared/w_up", params["shared"]["w_up"]),
                       ("shared/w_down", params["shared"]["w_down"]),
                       ("experts/w_gate", params["experts"]["w_gate"]),
                       ("experts/w_up", params["experts"]["w_up"]),
                       ("experts/w_down", params["experts"]["w_down"])):
        res["p/" + path] = np.asarray(leaf)
    # the logical weights: expert e is the mesh's row (e % M) * (E/M) + e // M
    phys = np.array([(e % M) * (E // M) + e // M for e in range(E)])
    logical = dict(params, experts={k: v[phys] for k, v in
                                    params["experts"].items()})
    for cf in FACTORS:
        cfg = ModelConfig(**_cfg_kw(cf))
        y, aux = jax.jit(lambda p, x: moe.moe_block(p, x, cfg, ctx))(
            params, jnp.asarray(x))
        res[f"mesh_y_{cf}"], res[f"mesh_aux_{cf}"] = np.asarray(y), float(aux)
    y, aux = moe.moe_block(logical, jnp.asarray(x), ModelConfig(
        **_cfg_kw(1.0)), None)
    res["dense_y"], res["dense_aux"] = np.asarray(y), float(aux)
    np.savez(out, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe") / "ref.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               f"={DP * M}", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in (str(SRC), os.environ.get(
                   "PYTHONPATH", "")) if p))
    proc = subprocess.run([sys.executable, str(HERE), "--jax-ref", out],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _port_moe(ref, cf):
    """The port's single-device MoE holding the logical weights."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe as tmoe

    cfg = ModelConfig(**_cfg_kw(cf))
    mod = tmoe.MoE(cfg, device="cpu")
    phys = [(e % M) * (E // M) + e // M for e in range(E)]
    with torch.no_grad():
        for name, p in mod.named_parameters():
            a = torch.from_numpy(ref["p/" + name.replace(".", "/")])
            p.copy_(a[phys] if name.startswith("experts.") else a)
    return cfg, mod


@pytest.mark.parametrize("cf", FACTORS)
def test_emulation_matches_jax_on_an_auto_mesh(jax_ref, cf):
    import torch

    from repro_torch.models import moe as tmoe

    cfg, mod = _port_moe(jax_ref, cf)
    x = torch.from_numpy(jax_ref["x"])
    with torch.no_grad():
        emu = tmoe.moe_block_spmd_emulated(mod, x, cfg, DP, M)
    want = jax_ref[f"mesh_y_{cf}"]
    scale = float(np.abs(want).max())
    err = float(np.abs(emu.y.numpy() - want).max()) / scale
    assert err < TOL, err
    # the reference mesh's aux is its ranks' own, averaged; the port's
    # mesh computes the single device's, of the whole batch
    assert abs(float(emu.aux_mean) - float(jax_ref[f"mesh_aux_{cf}"])) \
        < AUX_TOL
    assert abs(float(emu.aux) - float(jax_ref["dense_aux"])) < AUX_TOL
    if cf >= 8.0:
        assert emu.dropped == 0
        dense = jax_ref["dense_y"]
        assert float(np.abs(emu.y.numpy() - dense).max()) / scale < TOL
        with torch.no_grad():
            mine, _ = tmoe.moe_block(mod, x, cfg)
        assert float((mine - emu.y).abs().max()) / scale < TOL
    else:
        assert 0 < emu.dropped < emu.pairs
        assert float(np.abs(want - jax_ref["dense_y"]).max()) / scale > 0.01


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
def test_spmd_on_gloo_ranks_equals_the_emulation(cf):
    """``moe_block_spmd`` on 4 gloo ranks (data 2 x model 2; 8 experts, 4
    a rank) against ``moe_block_spmd_emulated`` of the same logical
    weights on the same input: the routed rows bitwise, the whole output
    (its shared experts tensor-parallel) within float32 rounding, the aux
    loss and the drop counts equal."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve.mesh_worker import LMMeshRun

    cfg = dataclasses.replace(ModelConfig(**_cfg_kw(cf)), num_layers=2,
                              first_dense_layers=0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # the helpers' thread count
    try:
        with LMMeshRun({"data": 2, "model": 2}, torch.device("cpu"),
                       timeout_s=120) as run:
            run.call("load", cfg, seed=3)
            # 12 tokens a data row split over its model ranks; 1 token a
            # data row does not (the rows cross data rows)
            got = [run.call("moe_check", shape, s) for s, shape in
                   enumerate([(4, 6, cfg.d_model), (2, 1, cfg.d_model)])]
    finally:
        torch.set_num_threads(threads)
    for res in got:
        assert res["routed_equal"], res
        assert res["max_rel_err"] < 1e-6, res
        assert abs(res["aux"] - res["aux_emulated"]) < 1e-7, res
        assert (res["dropped"], res["pairs"]) == (
            res["dropped_emulated"], res["pairs_emulated"]), res
    if cf < 1.0:
        assert any(r["dropped"] > 0 for r in got)


def _main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax-ref", required=True)
    args = ap.parse_args(argv)
    _jax_reference(args.jax_ref)


if __name__ == "__main__":
    _main()
