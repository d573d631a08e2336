"""LDA launcher -- a thin argv -> ``LDAJob`` translator over
``repro_torch.api``.

Every scenario is one declarative job: the launcher only parses flags,
optionally writes a synthetic corpus, builds the job and runs it through
``api.Session`` on ``--device`` (default ``cuda``: the card, where every
kernel of the path is the hand-written one; ``--device cpu`` runs the
plain PyTorch path).

In memory:
  PYTHONPATH=src python -m repro_torch.launch.lda --docs 2000 \\
      --vocab 5000 -k 100

Out-of-core: ``--stream-dir`` streams a sharded on-disk corpus through the
PS client shard by shard, checkpointing the PS state and the loader cursor
(``--checkpoint``, ``--checkpoint-every``); ``--resume`` continues a run
bitwise from its checkpoint:
  PYTHONPATH=src python -m repro_torch.launch.lda --stream-dir /data/s \\
      --epochs 2 --checkpoint-every 4
  PYTHONPATH=src python -m repro_torch.launch.lda --stream-dir /data/s \\
      --epochs 3 --resume

Multi-process (the network parameter server, DESIGN.md section 15):
``--backend net`` spawns an elastic localhost worker pool, each worker
sweeping on ``--device``, against an embedded server, or against an
already-running ``python -m repro_torch.launch.ps_server`` (or the JAX
package's) when ``--server host:port`` is given:
  PYTHONPATH=src python -m repro_torch.launch.ps_server \
      --stream-dir /data/s --topics 100 --ready-file /tmp/ps.addr
  PYTHONPATH=src python -m repro_torch.launch.lda --backend net \
      --workers 2 --server $(cat /tmp/ps.addr) --stream-dir /data/s -k 100

SPMD (``--devices N --mesh-model M``): N rank processes in a ``N/M x M``
``(data, model)`` mesh, workers = every rank (tokens split over data x
model), servers = the model axis (cyclic rows of n_wk, paper section 2.2),
over ``torch.distributed``: NCCL when each rank has a card of its own, gloo
when the ranks share one card or run on the CPU; with ``--stream-dir``,
groups of N stream shards feed the ranks:
  PYTHONPATH=src python -m repro_torch.launch.lda --devices 4 \
      --mesh-model 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch import api
from repro_torch.data import corpus as corpus_mod
from repro_torch.data import stream as stream_mod
from repro_torch.device import resolve_device


def _corpus_from_args(args):
    return corpus_mod.synthetic_corpus(
        args.docs, args.vocab, true_topics=args.true_topics,
        mean_doc_len=args.mean_doc_len, seed=args.seed)


def job_from_args(args) -> "api.LDAJob":
    """Translate the parsed argv into the declarative job (the launcher's
    whole remaining role)."""
    common = dict(num_topics=args.topics, mh_steps=args.mh_steps,
                  block_tokens=args.block_tokens,
                  staleness=args.staleness, hot_words=args.hot_words,
                  model_blocks=args.model_blocks, seed=args.seed,
                  eval_every=args.eval_every, sweeps=args.sweeps,
                  epochs=args.epochs)
    if args.trace_dir:
        common.update(obs=api.ObsConfig(enabled=True, out_dir=args.trace_dir))
    if args.devices:
        if args.model_blocks:
            print("[lda] note: --model-blocks is in-process only (the SPMD "
                  "backend uses the full-snapshot executor); ignoring")
        common.update(backend=api.SPMD, mesh_model=args.mesh_model,
                      model_blocks=0)
    elif args.backend == api.NET:
        common.update(backend=api.NET, workers=args.workers,
                      server=args.server or None,
                      net_assign=args.net_assign)
    elif args.server:
        raise api.JobValidationError(["--server requires --backend net"])

    if args.stream_dir:
        if not os.path.exists(os.path.join(args.stream_dir,
                                           stream_mod.MANIFEST)):
            corp = _corpus_from_args(args)
            meta = stream_mod.write_sharded(args.stream_dir, corp,
                                            args.stream_shard_tokens)
            print(f"[lda] sharded {meta.num_tokens} tokens into "
                  f"{meta.num_shards} shards at {args.stream_dir}")
        ckpt = api.CheckpointPolicy()
        if not args.devices and args.backend != api.NET:
            path = args.checkpoint or os.path.join(args.out,
                                                   "stream_ckpt.npz")
            ckpt = api.CheckpointPolicy(path=path,
                                        every=args.checkpoint_every,
                                        resume=args.resume)
        elif args.checkpoint or args.resume:
            print("[lda] note: checkpoint/resume is not supported on the "
                  "streamed SPMD/net paths; ignoring")
        return api.LDAJob(stream_dir=args.stream_dir, checkpoint=ckpt,
                          **common)

    corp = _corpus_from_args(args)
    print(f"[lda] corpus: {corp.num_tokens} tokens, {corp.num_docs} docs, "
          f"V={corp.vocab_size}")
    ckpt = api.CheckpointPolicy()
    if args.checkpoint and not args.devices:
        ckpt = api.CheckpointPolicy(path=args.checkpoint)
    return api.LDAJob(corpus=corp, checkpoint=ckpt, **common)


def run_single(corp, cfg, sweeps: int, seed: int, eval_every: int, out=None,
               model_blocks: int = 0, staleness: int = 0, hot_words=None,
               device=None):
    """Single-process in-memory training through the session on
    ``device`` (the card unless the caller passes another); returns
    ``(state, history)``.  ``out`` is unused, as in the JAX package."""
    job = api.LDAJob(corpus=corp, num_topics=cfg.num_topics,
                     vocab_size=cfg.vocab_size, alpha=cfg.alpha,
                     beta=cfg.beta, mh_steps=cfg.mh_steps,
                     block_tokens=cfg.block_tokens,
                     num_shards=cfg.num_shards,
                     model_blocks=model_blocks, staleness=staleness,
                     hot_words=hot_words, sweeps=sweeps, seed=seed,
                     eval_every=eval_every)
    res = api.Session(job, device=device).run()
    return res.state, res.history


def run_distributed(corp, cfg, sweeps: int, seed: int, eval_every: int,
                    mesh_model: int, staleness: int = 0, hot_words=None,
                    devices=None, device=None):
    """SPMD training through the session: ``devices`` ranks (None: the
    session's default) with ``mesh_model`` servers, on ``device`` (the card
    unless the caller passes another); returns the history list."""
    job = api.LDAJob(corpus=corp, num_topics=cfg.num_topics,
                     vocab_size=cfg.vocab_size, alpha=cfg.alpha,
                     beta=cfg.beta, mh_steps=cfg.mh_steps,
                     block_tokens=cfg.block_tokens,
                     backend=api.SPMD, mesh_model=mesh_model,
                     staleness=staleness, hot_words=hot_words,
                     sweeps=sweeps, seed=seed, eval_every=eval_every)
    return api.Session(job, device=device, devices=devices).run().history


def rank_launches_line(info: dict) -> str:
    """One line of an SPMD run's kernel launches, summed over its ranks
    (each rank counts its own; a CPU rank launches none)."""
    total: dict = {}
    for r in info["ranks"]:
        for name, n in r["launches"].items():
            total[name] = total.get(name, 0) + n
    return (f"[lda] kernel launches over {len(info['ranks'])} ranks "
            f"({info['collective']}): "
            + ", ".join(f"{k} {n}" for k, n in sorted(total.items())))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=1000)
    ap.add_argument("--mean-doc-len", type=int, default=80)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--true-topics", type=int, default=20)
    ap.add_argument("-k", "--topics", type=int, default=50)
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--mh-steps", type=int, default=2)
    ap.add_argument("--block-tokens", type=int, default=8192)
    ap.add_argument("--device", default="cuda",
                    help="where to train: 'cuda' (default: the card, every "
                         "kernel the hand-written one) or 'cpu' (the plain "
                         "PyTorch path)")
    ap.add_argument("--devices", type=int, default=0,
                    help="SPMD over N rank processes (a mesh of N / "
                         "--mesh-model data rows x --mesh-model servers)")
    ap.add_argument("--mesh-model", type=int, default=2)
    ap.add_argument("--backend", default="",
                    choices=["", api.IN_PROCESS, api.SPMD, api.NET],
                    help="parameter-server backend (default: inferred; "
                         "'net' trains through worker subprocesses against "
                         "a network PS, DESIGN.md sec. 15)")
    ap.add_argument("--server", default="",
                    help="net backend: address (host:port) of a running "
                         "launch.ps_server process (default: embed one)")
    ap.add_argument("--workers", type=int, default=2,
                    help="net backend: size of the localhost worker pool")
    ap.add_argument("--net-assign", default="dynamic",
                    choices=["dynamic", "static", "static_steal"],
                    help="net backend: shard-to-worker assignment policy")
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--model-blocks", type=int, default=0,
                    help="blocked/pipelined sweep (paper sec 3.4): pull the "
                         "model in N blocks instead of a full snapshot")
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded-staleness executor: up to S block deltas "
                         "in flight while a block samples (0 = synchronous; "
                         "rounded down so S+1 divides the block count)")
    ap.add_argument("--hot-words", type=int, default=None,
                    help="hybrid delta push: the H hottest words aggregate "
                         "densely, the cold tail is pushed as (row, col, "
                         "+/-1) coordinate deltas (default: all words dense)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default="",
                    help="enable the telemetry plane (repro_torch.obs): "
                         "write a Perfetto-loadable trace.json + "
                         "metrics.jsonl under this directory")
    ap.add_argument("--out", default="experiments/lda")
    ap.add_argument("--save-counts", default="",
                    help="write the final n_wk and n_k (dense, logical "
                         "rows) to this .npz")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--stream-dir", default="",
                    help="out-of-core training: shard the corpus into (or "
                         "reuse a manifest at) this directory and stream "
                         "it through the PS client shard by shard")
    ap.add_argument("--stream-shard-tokens", type=int, default=65536,
                    help="token capacity of each stream shard (must be a "
                         "multiple of --block-tokens for snapshot mode)")
    ap.add_argument("--epochs", type=int, default=3,
                    help="stream trainer: full passes over the shard "
                         "stream (per-epoch shard-order shuffle)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="stream trainer: checkpoint PS state + cursor "
                         "every N shard visits (0: only at the end)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the stream trainer from --checkpoint "
                         "(bitwise-identical continuation)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError:
        ap.error(f"no CUDA device available for --device {args.device}: "
                 "pass --device cpu to run the plain PyTorch path")
    if args.stream_dir:
        print(f"[lda] stream mode: training {args.epochs} epochs "
              f"(--sweeps is the in-memory trainer's knob and is ignored)")
    try:
        job = job_from_args(args)
        session = api.Session(job, device=device,
                              devices=args.devices or None)
        result = session.run()
    except api.JobValidationError as e:
        ap.error(str(e))

    if args.trace_dir:
        print(f"[lda] trace written to {job.obs.trace_path} (load in "
              f"Perfetto)")
    if args.backend == api.NET:
        print(f"[lda] net training done: {result.info.get('workers')} "
              f"workers against {result.info.get('server')}")
    elif args.stream_dir and not args.devices:
        print(f"[lda] stream training done ({result.info['mode']} "
              f"executor); checkpoint at {job.checkpoint.path}")
    elif args.checkpoint and not args.devices and not args.stream_dir:
        print(f"[lda] checkpointed assignments to {args.checkpoint}")
    if args.devices:
        print(rank_launches_line(result.info))
    if args.save_counts:
        np.savez(args.save_counts,
                 nwk=result.nwk.to_dense().cpu().numpy(),
                 nk=result.nk.value.cpu().numpy())

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "history.json"), "w") as f:
        json.dump(result.history, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
