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
``main`` returns the state and history to an in-process caller.  One
device only: ``--mesh host|pod|multipod`` is ROADMAP A.8.3's training
half (the port serves on a mesh: ``launch.serve --mesh host``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.lm_data import LMDataConfig, MarkovZipfSource
from repro_torch.device import resolve_device
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
    state: train_loop.TrainState
    history: List[dict]
    cfg: ModelConfig
    tc: TrainConfig


def build_cfg(args) -> ModelConfig:
    if args.preset == "lm100m":
        return LM100M
    if args.smoke:
        return registry.smoke_variant(args.arch)
    return registry.get(args.arch)


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
    args = ap.parse_args(argv)

    if args.mesh != "none":
        ap.error(f"--mesh {args.mesh}: training on a device mesh is ROADMAP "
                 "A.8.3's training half, not ported yet; the port trains on "
                 "one device")
    try:
        device = resolve_device(args.device)
    except RuntimeError:
        ap.error(f"no CUDA device available for --device {args.device}: "
                 "pass --device cpu to run the plain PyTorch path")
    cfg = build_cfg(args)

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

    state = train_loop.init_state(args.seed, cfg, device=device)
    state, history = train_loop.fit(state, src.batches(args.steps), cfg, tc,
                                    log_every=args.log_every)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{cfg.name}_history.json"),
                  "w") as f:
            json.dump(history, f, indent=2)
        checkpoint.save(os.path.join(args.out, f"{cfg.name}_final.npz"),
                        convert.lm_arrays_from_params(state.model))
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return TrainResult(state, history, cfg, tc)


if __name__ == "__main__":
    main()
    sys.exit(0)
