"""Per-rank bytes of every architecture on the production meshes, under the
partition rules.

The counterpart of the JAX package's ``repro.launch.dryrun``, which lowers
and compiles each (architecture x input shape) step on the 256- and
512-chip TPU meshes.  The port has no such mesh and lowers nothing: it
builds each model's parameter shapes on the meta device (no allocation),
stacks each layer list into the reference's ``[L, ...]`` leaves, lays the
vocab tables out for the mesh's model axis, and applies
``sharding.specs`` -- ``param_specs`` (the parameters, in their dtype),
``opt_state_specs`` (AdamW's two float32 moments, ZeRO-sharded over the dp
axes) and ``cache_specs`` (the prefill and decode caches) -- to give the
bytes one rank holds.  A split dim that does not divide is padded, as a
``NamedSharding`` pads it.

These are the rules' bytes.  The port's own blocks differ in two places,
each documented where it is made: where KV heads do not tile the model
axis its caches hold whole KV heads (``sharding.specs.cache_specs``), and
an SSM mixer whose heads tile the axis holds its ``in_proj`` columns
regrouped as ``[z | x of its heads | B | C]`` and its conv channels as
``[x of its heads | B | C]`` (``models/ssm.py``): ``2 N (1 - 1/M)`` more
columns of ``in_proj`` and as many more conv channels a rank than the
rules' contiguous block (mamba2-370m on a model axis of 16: 512 of
``in_proj``'s 4,352 columns against the rules' 272), while its per-head
leaves split by heads where the rules replicate them.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 16 x 16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod # 2 x 16 x 16
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import INPUT_SHAPES, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import VocabLayout
from repro_torch.sharding import specs

GIB = 2 ** 30
CACHE_KIND = {"k": "kv", "v": "kv", "ckv": "mla", "krope": "mla",
              "ssm": "ssm_state", "conv": "conv"}


class ProductionMesh:
    """The reference's production mesh shape, for the rules alone: (data
    16, model 16), or (pod 2, data 16, model 16)."""

    def __init__(self, multi_pod: bool = False):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.devices = np.empty((2, 16, 16) if multi_pod else (16, 16))

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.devices.shape)


def ctx_for(mesh) -> specs.MeshCtx:
    dp = tuple(a for a in mesh.axis_names if a != "model")
    return specs.MeshCtx(mesh, dp, "model")


class Leaf:
    """A shape and dtype stand-in (what ``jax.eval_shape`` gives)."""

    def __init__(self, shape, dtype: torch.dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


def param_tree(cfg: ModelConfig, model_size: int) -> dict:
    """The reference's ``init_params`` shapes for a model axis of
    ``model_size``: nested dicts of ``Leaf``, layer lists stacked."""
    model = tfm.Transformer(cfg, device="meta")
    pad = VocabLayout(cfg.vocab_size, model_size, cfg.vocab_layout).pad_rows
    tree: dict = {}
    stacks: Dict[tuple, list] = {}
    for name, p in model.named_parameters():
        path = tuple(name.split("."))
        shape = tuple(p.shape)
        if path[-1] == "table":
            shape = (pad,) + shape[1:]
        if path[0] in ("blocks", "dense_blocks", "cross_blocks"):
            stacks.setdefault((path[0],) + path[2:], []).append(
                Leaf(shape, p.dtype))
            continue
        _put(tree, path, Leaf(shape, p.dtype))
    for path, leaves in stacks.items():
        _put(tree, path, Leaf((len(leaves),) + leaves[0].shape,
                              leaves[0].dtype))
    return tree


def _put(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = leaf


def _walk(tree, spec_tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], spec_tree[k])
    else:
        yield tree, spec_tree


def shard_bytes(shape, itemsize: int, spec, mesh) -> int:
    """Bytes of one rank's block of a ``shape`` leaf under ``spec`` (a
    split dim that does not divide is padded to the next multiple)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n = itemsize
    for dim, size in enumerate(shape):
        part = spec[dim] if dim < len(spec) else None
        axes = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        n *= math.ceil(size / math.prod(sizes[a] for a in axes))
    return n


def rank_bytes(cfg: ModelConfig, shape_name: str, mesh) -> dict:
    """One rank's parameter, AdamW-moment and cache bytes for ``cfg`` at
    input shape ``shape_name`` on ``mesh``."""
    ctx = ctx_for(mesh)
    tree = param_tree(cfg, ctx.model_size)
    params = sum(shard_bytes(leaf.shape, leaf.dtype.itemsize, spec, mesh)
                 for leaf, spec in _walk(tree, specs.param_specs(tree, ctx)))
    moments = 2 * sum(shard_bytes(leaf.shape, 4, spec, mesh) for leaf, spec
                      in _walk(tree, specs.opt_state_specs(tree, ctx)))
    shape = INPUT_SHAPES[shape_name]
    cache = 0
    if shape.kind != "train":
        cspec = specs.cache_specs(cfg, shape, ctx)
        for leaves in registry.cache_shapes(cfg, shape.global_batch,
                                            shape.seq_len).values():
            for name, (shp, dt) in leaves.items():
                cache += shard_bytes(shp, dt.itemsize,
                                     cspec[CACHE_KIND[name]], mesh)
    return {"arch": cfg.name, "shape": shape_name, "mesh": mesh.name,
            "kind": shape.kind, "param_bytes": params,
            "moment_bytes": moments, "cache_bytes": cache}


def combos():
    for arch in registry.all_arch_names():
        cfg = registry.get(arch)
        for sn in INPUT_SHAPES:
            if registry.shape_supported(cfg, INPUT_SHAPES[sn]):
                yield arch, sn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="one JSON object a line instead of the table")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh = ProductionMesh(args.multi_pod)
    todo = list(combos()) if args.all else [(args.arch, args.shape)]
    for arch, sn in todo:
        row = rank_bytes(registry.get(arch), sn, mesh)
        if args.json:
            print(json.dumps(row))
            continue
        total = row["param_bytes"] + row["cache_bytes"] + (
            row["moment_bytes"] if row["kind"] == "train" else 0)
        print(f"[dryrun] {arch}:{sn}:{mesh.name} params "
              f"{row['param_bytes'] / GIB:.3f} GiB, AdamW moments "
              f"{row['moment_bytes'] / GIB:.3f} GiB, cache "
              f"{row['cache_bytes'] / GIB:.3f} GiB per rank "
              f"({total / GIB:.3f} GiB for a {row['kind']} step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
