"""Serving launcher: batched generation with the cache engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
      --smoke --batch 4 --prompt-len 32 --gen 32 --device cpu

The same argv as the JAX package's ``repro.launch.serve``, plus
``--device`` (default ``cuda``: the card; ``cpu`` runs the plain PyTorch
path), ``--seed`` (the weights, drawn on the device, and the prompts,
which are ``jax.random.randint``'s for that seed bitwise) and ``--layers``
(cut the depth; the widths stay the config's).  ``main``
returns the engine and its output to an in-process caller.

``--mesh host`` serves on a mesh of ranks over the host's cards, as the
reference's ``make_host_mesh``: by default data = the cards, model = 1
(on one card a mesh of 1, which prints the same tokens as ``--mesh
none``); ``--devices N --mesh-model M`` runs N rank processes in an
``N/M x M`` mesh that share the cards (or the CPU), as ``launch.lda``'s
do: NCCL when each rank has a card of its own, else gloo.  Rank 0 is
this process (``serve.mesh_worker``).  Every arch serves on any such
mesh: the SSM families split their mixer by heads or gather it
(``sharding.specs.ssm_split``), and a ``--batch`` smaller than the data
axis is served with the attention caches sequence-sharded over the data
ranks (``serve.engine``), e.g. ``--batch 1 --mesh host --devices 2``.
``--mesh pod|multipod`` (the reference's TPU pods) exits 2: that layout
has no host counterpart; ``repro_torch.launch.dryrun`` gives the bytes a
rank holds on it.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import torch

from repro_torch import rng
from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import Engine, ServeConfig


@dataclasses.dataclass
class ServeResult:
    engine: Optional[Engine]     # None on a mesh: the ranks hold the model
    prompts: torch.Tensor
    cond: Optional[torch.Tensor]
    out: torch.Tensor
    seconds: float
    # on a mesh: rank 0's timed parts of generate, every rank's stats
    mesh: Optional[dict] = None


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "host", "pod", "multipod"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
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
    cfg = registry.smoke_variant(args.arch) if args.smoke \
        else registry.get(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    layout = None
    if args.mesh == "host":
        try:
            layout = mesh_mod.make_host_mesh(
                args.mesh_model,
                devices=args.devices or (None if device.type == "cuda"
                                         else 1))
        except ValueError as e:
            ap.error(str(e))

    prompts = rng.randint(rng.PRNGKey(args.seed),
                          (args.batch, args.prompt_len), 0,
                          cfg.vocab_size).to(device)
    cond = None
    if cfg.cross_attn_mode:
        g = torch.Generator(device=device).manual_seed(args.seed)
        cond = torch.randn((args.batch, cfg.cond_len, cfg.cond_dim_),
                           generator=g, device=device)
    max_seq = args.prompt_len + args.gen + 1
    mesh = None
    if layout is not None:
        out, dt, mesh = _serve_on_mesh(layout, cfg, args, device, prompts,
                                       cond, max_seq)
        engine = None
    else:
        model = tfm.init_params(args.seed, cfg, device=device)
        engine = Engine(model, ServeConfig(
            max_seq=max_seq, temperature=args.temperature, seed=args.seed))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.gen, cond=cond)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
    tps = args.batch * args.gen / dt
    print(f"[serve] {cfg.name}: generated {tuple(out.shape)} tokens in "
          f"{dt:.2f}s ({tps:.1f} tok/s, batch={args.batch})")
    if mesh is not None:
        t = mesh["timed"]
        steps = sorted(t["step_ms"])
        print(f"[serve] rank 0: prefill {t['prefill_ms']:.1f} ms, decode "
              f"step {steps[len(steps) // 2] if steps else 0.0:.2f} ms "
              "median")
    print("[serve] sample:", out[0, :16].tolist())
    return ServeResult(engine, prompts, cond, out, dt, mesh)


def _serve_on_mesh(layout, cfg, args, device, prompts, cond, max_seq):
    """``Engine.generate`` on every rank of the mesh, each part timed
    (``op_generate(timed=True)``); returns rank 0's tokens (on
    ``device``), the seconds it took, and the mesh's numbers: rank 0's
    timed parts, every rank's ``op_stats``, and the seconds the ranks took
    to start and rank 0 to build its blocks."""
    from repro_torch.serve.mesh_worker import LMMeshRun

    spec = {"data": layout.data, "model": layout.model}
    c = None if cond is None else cond.cpu()
    t0 = time.perf_counter()
    with LMMeshRun(spec, device) as run:
        start_s = time.perf_counter() - t0
        print(f"[serve] mesh {layout.data} x {layout.model} over "
              f"{run.transport} ({run.world} ranks)")
        load = run.call("load", cfg, seed=args.seed, max_seq=max_seq,
                        temperature=args.temperature)
        run.call("reset_peak")
        t0 = time.perf_counter()
        timed = run.call("generate", prompts.cpu(), args.gen, c, timed=True)
        out = timed.pop("tokens")
        dt = time.perf_counter() - t0
        mesh = {"timed": timed, "stats": run.call("stats"),
                "transport": run.transport, "start_s": start_s,
                "load_s": load["load_s"]}
    return out.to(device), dt, mesh


if __name__ == "__main__":
    main()
    sys.exit(0)
