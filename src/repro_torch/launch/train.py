"""Training launcher: ``--arch <id>`` (full or smoke variant) on synthetic
Markov-Zipf LM data.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m --steps 300

The same argv as the JAX package's ``repro.launch.train``, plus
``--device`` (default ``cuda``: the card; ``cpu`` runs the plain PyTorch
path), ``--microbatch`` (``TrainConfig.microbatch``: float32 gradient
accumulation over that many microbatches), ``--log-every`` (the history's
stride, 10 as the reference's) and ``--out ''`` (write nothing).  It
writes ``<name>_history.json`` and ``<name>_final.npz`` under ``--out``,
the npz in the JAX package's layout (stacked ``[L, ...]`` layers,
``/``-joined keys), so ``repro.train.checkpoint.restore`` reads it.
``--preset lm100m`` is the end-to-end driver config (~100M params).  The
weights are drawn from ``--seed`` on the device (the JAX package's
distributions, not its bits); the batches equal the JAX launcher's bitwise.
``main`` returns the state and history to an in-process caller.

``--mesh host`` trains on a mesh of ranks, as ``launch.serve --mesh
host`` serves: by default data = the cards, model = 1; ``--devices N
--mesh-model M`` runs N rank processes in an ``N/M x M`` mesh that share
the cards (or the CPU), NCCL when each rank has a card of its own, else
gloo (``train.mesh_worker``; rank 0 is this process).  Every rank draws
its blocks of the single-device weights of ``--seed`` and takes the
same steps as ``--mesh none`` on the same batches (parameters split by
the rules, AdamW moments ZeRO-split over the data axis); rank 0 writes
the npz, gathered to the JAX layout.  Every arch trains on any such
mesh (the SSM families split their mixer by heads or gather it,
``sharding.specs.ssm_split``).  ``--layers`` cuts the depth (the widths
stay the config's).  ``--mesh pod|multipod`` (the reference's TPU pods)
exits 2: that layout has no host counterpart; ``repro_torch.launch.dryrun``
gives the bytes a rank holds on it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import checkpoint
from repro_torch.train import loop as train_loop

LM100M = ModelConfig(
    name="lm100m", arch_type="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
    head_dim=64, tie_embeddings=True, dtype="float32", remat=False,
    attn_chunk_q=512, attn_chunk_kv=512,
    source="end-to-end driver (~100M params)")


@dataclasses.dataclass
class TrainResult:
    state: Optional[train_loop.TrainState]   # None on a mesh: ranks hold it
    history: List[dict]
    cfg: ModelConfig
    tc: TrainConfig
    # on a mesh: rank 0's ``op_train_init`` result, every rank's from
    # ``op_train_fit`` (collectives, peak memory, blocks that moved), the
    # ranks' start seconds
    mesh: Optional[dict] = None


def build_cfg(args) -> ModelConfig:
    if args.preset == "lm100m":
        cfg = LM100M
    elif args.smoke:
        cfg = registry.smoke_variant(args.arch)
    else:
        cfg = registry.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--preset", default="")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="none", choices=["none", "host", "pod",
                                                       "multipod"])
    ap.add_argument("--out", default="experiments/train",
                    help="directory of the history and final npz ('': "
                         "write nothing)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--devices", type=int, default=0,
                    help="--mesh host: rank processes (default: the cards)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="--mesh host: the model axis")
    args = ap.parse_args(argv)

    if args.mesh in ("pod", "multipod"):
        try:
            mesh_mod.make_production_mesh(multi_pod=args.mesh == "multipod")
        except NotImplementedError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        ap.error(f"no CUDA device available for --device {args.device}: "
                 "pass --device cpu to run the plain PyTorch path")
    cfg = build_cfg(args)
    layout = None
    if args.mesh == "host":
        try:
            layout = mesh_mod.make_host_mesh(
                args.mesh_model,
                devices=args.devices or (None if device.type == "cuda"
                                         else 1))
        except ValueError as e:
            ap.error(str(e))

    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 5), seed=args.seed,
                     microbatch=args.microbatch)
    print(f"[train] {cfg.name}: ~{cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active), "
          f"batch={args.batch} seq={args.seq} steps={args.steps} "
          f"microbatch={args.microbatch} on {device}")

    src = MarkovZipfSource(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch,
        seed=args.seed,
        cond_len=cfg.cond_len if cfg.cross_attn_mode else 0,
        cond_dim=cfg.cond_dim_ if cfg.cross_attn_mode else 0))

    mesh = None
    if layout is not None:
        state = None
        history, final, mesh = _train_on_mesh(
            layout, cfg, tc, args, device, list(src.batches(args.steps)))
    else:
        state = train_loop.init_state(args.seed, cfg, device=device)
        state, history = train_loop.fit(state, src.batches(args.steps), cfg,
                                        tc, log_every=args.log_every)
        final = None

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{cfg.name}_history.json"),
                  "w") as f:
            json.dump(history, f, indent=2)
        checkpoint.save(os.path.join(args.out, f"{cfg.name}_final.npz"),
                        final if final is not None else
                        convert.lm_arrays_from_params(state.model))
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return TrainResult(state, history, cfg, tc, mesh)


def _train_on_mesh(layout, cfg, tc, args, device, batches):
    """``fit`` on every rank of the mesh; returns rank 0's history, when
    ``--out`` asks for it the final parameters in the JAX layout, and the
    mesh's numbers (``TrainResult.mesh``; ``start_s``: the seconds the
    ranks took to start)."""
    from repro_torch.train.mesh_worker import LMTrainRun

    spec = {"data": layout.data, "model": layout.model}
    t0 = time.perf_counter()
    with LMTrainRun(spec, device) as run:
        start_s = time.perf_counter() - t0
        print(f"[train] mesh {layout.data} x {layout.model} over "
              f"{run.transport} ({run.world} ranks)")
        init = run.call("train_init", cfg, tc, seed=args.seed)
        res = run.call("train_fit", batches, args.log_every)
        final = run.arrays(cfg, "params")["params"] if args.out else None
    return res["history"], final, {"init": init, "ranks": res["ranks"],
                                   "transport": run.transport,
                                   "start_s": start_s}


if __name__ == "__main__":
    main()
    sys.exit(0)
