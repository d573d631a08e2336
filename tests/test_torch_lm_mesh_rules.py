"""The port's partition rules against the JAX package's, on the shapes of
every architecture at its full config: ``param_specs``, ``opt_state_specs``
and ``cache_specs`` leaf by leaf on ``jax.eval_shape`` trees of the JAX
``init_params`` for meshes of data 2 x model 4, 16 x 16 and 2 x 16 x 16
(stand-in mesh objects with ``axis_names`` and ``devices``), the dry-run's
per-rank bytes against the JAX specs applied to the same shapes, each
rank's block (``local_shard``), the mesh helpers, and the converters' round
trip between the JAX pytree and every rank's blocks (bitwise)."""
import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg
from repro.configs.base import INPUT_SHAPES
from repro.models import transformer as jtfm
from repro.sharding import specs as jspecs
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttfm
from repro_torch.sharding import specs as tspecs

ARCHS = jreg.all_arch_names()
MESHES = {"2x4": (("data", "model"), (2, 4)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


class StandIn:
    """A mesh for the rules alone: axis names and a devices array."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


def _ctxs(mesh_name):
    names, shape = MESHES[mesh_name]
    mesh = StandIn(names, shape)
    dp = tuple(a for a in names if a != "model")
    return (mesh, jspecs.MeshCtx(mesh, dp, "model"),
            tspecs.MeshCtx(mesh, dp, "model"))


_SHAPES = {}


def _eval_shape(arch, jctx):
    key = (arch, jctx.model_size)
    if key not in _SHAPES:
        cfg = jreg.get(arch)
        _SHAPES[key] = jax.eval_shape(
            lambda k: jtfm.init_params(k, cfg, jctx), jax.random.PRNGKey(0))
    return _SHAPES[key]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_jax(arch, mesh_name):
    _, jctx, tctx = _ctxs(mesh_name)
    shapes = _eval_shape(arch, jctx)
    for fn in ("param_specs", "opt_state_specs"):
        want = _flat(getattr(jspecs, fn)(shapes, jctx))
        got = _flat(getattr(tspecs, fn)(shapes, tctx))
        assert set(got) == set(want), fn
        for path in want:
            assert tuple(got[path]) == tuple(want[path]), (fn, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_match_jax(mesh_name):
    _, jctx, tctx = _ctxs(mesh_name)
    for arch in ARCHS:
        for shape in INPUT_SHAPES.values():
            want = jspecs.cache_specs(jreg.get(arch), shape, jctx)
            got = tspecs.cache_specs(treg.get(arch), shape, tctx)
            assert set(got) == set(want)
            for k in want:
                w, g = want[k], got[k]
                assert (tuple(g) if isinstance(g, tuple) else g) == \
                    (tuple(w) if isinstance(w, tuple) else w), (arch, k)


def _jax_bytes(shapes, spec_tree, mesh, itemsize=None):
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    specs, leaves = _flat(spec_tree), _flat(shapes)
    for path, leaf in leaves.items():
        spec = tuple(specs[path])
        n = itemsize or np.dtype(leaf.dtype).itemsize
        for dim, size in enumerate(leaf.shape):
            part = spec[dim] if dim < len(spec) else None
            axes = () if part is None else (part if isinstance(part, tuple)
                                            else (part,))
            n *= math.ceil(size / math.prod(sizes[a] for a in axes))
        total += n
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dryrun_bytes_match_the_jax_specs(multi_pod):
    """Per-rank parameter, AdamW-moment and cache bytes of every arch x
    input shape: the port's dry-run against the JAX specs applied to
    ``jax.eval_shape`` shapes (caches: the JAX registry's decode-cache
    shapes under its ``cache_specs``)."""
    mesh = tdry.ProductionMesh(multi_pod)
    names = mesh.axis_names
    dp = tuple(a for a in names if a != "model")
    jctx = jspecs.MeshCtx(StandIn(names, mesh.devices.shape), dp, "model")
    kind = {"k": "kv", "v": "kv", "ckv": "mla", "krope": "mla",
            "ssm": "ssm_state", "conv": "conv"}
    rows = 0
    for arch, sn in tdry.combos():
        got = tdry.rank_bytes(treg.get(arch), sn, mesh)
        shapes = _eval_shape(arch, jctx)
        assert got["param_bytes"] == _jax_bytes(
            shapes, jspecs.param_specs(shapes, jctx), mesh), (arch, sn)
        assert got["moment_bytes"] == 2 * _jax_bytes(
            shapes, jspecs.opt_state_specs(shapes, jctx), mesh, 4), arch
        shape = INPUT_SHAPES[sn]
        want = 0
        if shape.kind != "train":
            cs = jspecs.cache_specs(jreg.get(arch), shape, jctx)
            caches = jreg.cache_shapes(jreg.get(arch), shape.global_batch,
                                       shape.seq_len)
            for leaves in caches.values():
                for name, leaf in leaves.items():
                    want += _jax_bytes({name: leaf}, {name: cs[kind[name]]},
                                       mesh)
        assert got["cache_bytes"] == want, (arch, sn)
        rows += 1
    assert rows == len(list(tdry.combos())) >= 30


def test_dryrun_cli_prints_every_combo(capsys):
    assert tdry.main(["--all"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[dryrun]")]
    assert len(lines) == len(list(tdry.combos()))
    assert all(":16x16 params" in l for l in lines)


def test_local_shard_blocks_tile_the_array():
    """Every rank's blocks of a leaf, placed back by their grid index,
    rebuild it; a dim that does not split raises."""
    mesh = tmesh.MeshLayout(2, 4)
    ctx = tmesh.ctx_for(mesh)
    a = np.arange(8 * 12 * 6).reshape(8, 12, 6)
    for spec in (tspecs.P("model", ("data",), None), tspecs.P(None, "model"),
                 tspecs.P(("data", "model")), tspecs.P()):
        out = np.zeros_like(a)
        for r in range(8):
            blk = tspecs.local_shard(a, spec, mesh, r)
            grid = tspecs.shard_grid(spec, mesh, r)
            idx = tuple(slice(i * blk.shape[d], (i + 1) * blk.shape[d])
                        for d, (_, i) in enumerate(grid))
            out[idx] = blk
        np.testing.assert_array_equal(out, a)
    with pytest.raises(ValueError, match="does not split"):
        tspecs.local_shard(np.zeros((6, 3)), tspecs.P(None, "model"), mesh, 0)
    assert ctx.model_size == 4 and ctx.dp_size == 2 and ctx.num_devices == 8


def test_mesh_helpers():
    lay = tmesh.make_host_mesh(2, devices=4)
    assert (lay.data, lay.model) == (2, 2)
    assert tuple(lay.devices.shape) == (2, 2)
    ctx = tmesh.ctx_for(lay)
    assert ctx.dp == ("data",) and ctx.model == "model"
    assert ctx.comm is None
    with pytest.raises(ValueError, match="divisible"):
        tmesh.make_host_mesh(3, devices=4)
    for multi in (False, True):
        with pytest.raises(NotImplementedError,
                           match="no host counterpart"):
            tmesh.make_production_mesh(multi_pod=multi)
    x = torch.zeros(2, 3)
    assert ctx.constrain(x, tspecs.P("data", None)) is x
    with pytest.raises(AssertionError):
        ctx.constrain(x, tspecs.P("pod"))


@pytest.mark.parametrize("shape,layout_shards", [((2, 2), 1), ((1, 4), 4),
                                                 ((2, 2), 3)])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "gemma3-4b",
                                  "llama-3.2-vision-11b"])
def test_convert_round_trip_is_bitwise(arch, shape, layout_shards):
    """JAX arrays made for a model axis of ``layout_shards`` -> every
    rank's blocks -> the JAX pytree again: equal bitwise (the padding rows
    of a padded layout come back zero; every logical row is equal)."""
    # 8 experts, so that the cyclic expert order of 2 or 4 model ranks is
    # not the identity
    more = {"num_experts": 8} if jreg.get(arch).num_experts else {}
    cfg = dataclasses.replace(jreg.smoke_variant(arch), **more)
    jctx = jspecs.MeshCtx(StandIn(("data", "model"), (1, layout_shards)),
                          ("data",), "model")
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(7), cfg, jctx))
    tcfg = dataclasses.replace(treg.smoke_variant(arch), **more)
    ctx = tmesh.ctx_for(tmesh.MeshLayout(*shape))
    shards = [convert.lm_shard_from_arrays(params, tcfg, ctx, r, "cpu",
                                           layout_shards)
              for r in range(shape[0] * shape[1])]
    back = convert.lm_arrays_from_shards(shards, tcfg, ctx, layout_shards)
    want, got = _flat(params), _flat(back)
    assert set(got) == set(want)
    lay = jtfm.vocab_layout(cfg, jctx)
    live = np.asarray(lay.to_physical(np.arange(cfg.vocab_size)))
    for path, a in want.items():
        b = got[path]
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if path.endswith("table"):
            a, b = a[live], b[live]
        np.testing.assert_array_equal(b, a, err_msg=path)
    # rank 0's blocks are the rules' blocks of the logical weights
    blocks = dict(shards[0].named_parameters())
    assert blocks["embed.table"].shape[0] == \
        ttfm.vocab_layout(tcfg, ctx).pad_rows // shape[1]
