"""Topic inference serving launcher: train -> snapshot -> serve.

Self-contained smoke of the whole serving path, including the concurrent
admission plane and live refresh, on the card (``--device cpu`` runs the
plain PyTorch path):

  PYTHONPATH=src python -m repro_torch.launch.topic_serve --selftest

Full control:

  PYTHONPATH=src python -m repro_torch.launch.topic_serve --docs 2000 \\
      --vocab 5000 -k 100 --sweeps 40 --publish-every 10 \\
      --serve-docs 64 --queries 4 \\
      --clients 8 --max-delay-ms 5 --deadline-ms 200 --refresh-every 2

Train a model with ``repro_torch.launch.lda`` semantics, publish versioned
snapshots while training, fold in held-out documents through the batched
query engine, rank them with topic-smoothed query likelihood -- then
(``--clients`` > 0) serve concurrent client threads through the
dual-trigger batcher while a background trainer live-refreshes the
snapshot every ``--refresh-every`` sweeps.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

from repro_torch import rng as jrng
from repro_torch.core import lightlda as lda
from repro_torch.data import corpus as corpus_mod
from repro_torch.device import resolve_device
from repro_torch.infer.engine import DeadlineExceeded, EngineConfig
from repro_torch.infer.foldin import FoldInConfig
from repro_torch.serve.topic_service import TopicService
from repro_torch.train.async_exec import ExecConfig


def _docs_from_corpus(corp, num: int):
    """First ``num`` documents as token-id lists."""
    out = []
    for doc in range(min(num, corp.num_docs)):
        s, l = int(corp.doc_start[doc]), int(corp.doc_len[doc])
        out.append(corp.w[s:s + l])
    return out


def _topic_queries(snap, num_queries: int, terms: int = 3):
    """Synthetic queries: the most *distinctive* words of the heaviest
    topics (what an exploratory-search user hunting that topic would type).
    Distinctiveness divides out the Zipfian word marginal so queries do not
    all collapse onto the globally-frequent words."""
    phi = snap.phi.cpu().numpy()
    lift = phi / np.maximum(phi.sum(axis=1, keepdims=True), 1e-30)
    heavy = np.argsort(-snap.model.nk.cpu().numpy())[:num_queries]
    return [np.argsort(-lift[:, k])[:terms].astype(np.int32) for k in heavy]


def run(args) -> int:
    t_start = time.time()
    device = resolve_device(args.device)
    corp = corpus_mod.synthetic_corpus(
        args.docs, args.vocab, true_topics=args.true_topics,
        mean_doc_len=args.mean_doc_len, seed=args.seed)
    train_corp, held = corpus_mod.train_heldout_split(corp, 0.1,
                                                      seed=args.seed + 1)
    print(f"[topic_serve] corpus: {train_corp.num_tokens} train tokens / "
          f"{held.num_tokens} held-out, V={corp.vocab_size}, on {device}")

    cfg = lda.LDAConfig(num_topics=args.topics, vocab_size=args.vocab,
                        mh_steps=args.mh_steps,
                        block_tokens=args.block_tokens)
    ecfg = EngineConfig(
        max_batch=args.serve_batch,
        max_delay_ms=args.max_delay_ms,
        deadline_ms=args.deadline_ms,
        foldin=FoldInConfig(num_sweeps=args.foldin_sweeps,
                            burnin=args.foldin_burnin))
    # the launcher's exact training spec: staleness / blocks / push route
    exec_cfg = ExecConfig(staleness=args.staleness,
                          hot_words=args.hot_words,
                          model_blocks=args.model_blocks)
    svc = TopicService(cfg, ecfg, exec_cfg=exec_cfg, device=device)
    svc.init_from_corpus(train_corp, seed=args.seed)
    print(f"[topic_serve] training via PSClient route "
          f"{exec_cfg.resolve_route(cfg.V)!r} (staleness "
          f"{exec_cfg.staleness}, model_blocks {exec_cfg.model_blocks})")

    # --- train, publishing versioned snapshots along the way -----------
    t0 = time.time()
    snap = svc.train(args.sweeps, jrng.PRNGKey(args.seed + 2),
                     publish_every=args.publish_every)
    print(f"[topic_serve] trained {args.sweeps} sweeps in "
          f"{time.time()-t0:.1f}s; published snapshot v{snap.version} "
          f"({svc.version} versions total)")

    # --- fold in held-out docs through the batched engine ---------------
    docs = _docs_from_corpus(held, args.serve_docs)
    if not docs:
        print("[topic_serve] no held-out docs to serve")
        return 1
    t0 = time.time()
    results = svc.fold_in(docs, seeds=list(range(len(docs))))
    dt = time.time() - t0
    print(f"[topic_serve] folded in {len(docs)} docs in {dt:.2f}s "
          f"({len(docs)/dt:.1f} docs/s) against snapshot "
          f"v{results[0].version}")
    for r in results[:4]:
        top = np.argsort(-r.theta)[:3]
        print(f"[topic_serve]   doc {r.rid}: top topics "
              + ", ".join(f"k={k} θ={r.theta[k]:.3f}" for k in top))

    # --- topic-smoothed query-likelihood ranking ------------------------
    queries = _topic_queries(snap, args.queries)
    scores = svc.score(queries, docs, results)
    for qi, q in enumerate(queries):
        rank = np.argsort(-scores[qi])[:3]
        print(f"[topic_serve]   query {q.tolist()}: best docs "
              + ", ".join(f"{d} ({scores[qi, d]:.1f})" for d in rank))

    # --- concurrent serving under live refresh --------------------------
    concurrent_ok = True
    if args.clients > 0:
        concurrent_ok = _serve_concurrent(svc, args)

    elapsed = time.time() - t_start
    print(f"[topic_serve] end-to-end {elapsed:.1f}s")

    if args.selftest:
        # train() publishes every publish_every sweeps plus once at the end
        expect_versions = 1 + (args.sweeps // args.publish_every
                               if args.publish_every else 0)
        ok = (svc.version >= expect_versions
              and len(results) == len(docs)
              and all(abs(r.theta.sum() - 1.0) < 1e-3 for r in results)
              and np.isfinite(scores).all()
              and concurrent_ok)
        print(f"[topic_serve] selftest {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1
    return 0 if concurrent_ok else 1


def _serve_concurrent(svc: TopicService, args) -> bool:
    """Drive ``--clients`` submitter threads through the dual-trigger
    batcher while a background trainer live-refreshes the published
    snapshot.  Returns True when every request was either served or
    typed-shed and at least one zero-downtime swap landed under load."""
    svc.start_serving()          # batching knobs come from the EngineConfig
    v0 = svc.version
    trainer = svc.train_async(args.refresh_sweeps,
                              jrng.PRNGKey(args.seed + 3),
                              publish_every=args.refresh_every)

    lock = threading.Lock()
    served, shed, errors = [], [], []

    def client(ci: int) -> None:
        rng = np.random.default_rng(7000 + ci)
        tickets = [svc.submit(
            rng.integers(0, args.vocab,
                         size=int(rng.integers(4, 80))).astype(np.int32),
            seed=ci * 10_000 + i) for i in range(args.client_requests)]
        for t in tickets:
            try:
                r = t.result(timeout=300)
                with lock:
                    served.append(r)
            except DeadlineExceeded as exc:
                with lock:
                    shed.append(exc)
            except Exception as exc:   # noqa: BLE001 -- selftest verdict
                with lock:
                    errors.append(exc)

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(ci,), daemon=True)
               for ci in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.time() - t0
    trainer.join()
    svc.stop_serving()

    total = args.clients * args.client_requests
    swaps = svc.version - v0
    versions = sorted({r.version for r in served})
    print(f"[topic_serve] concurrent: {len(served)} served / "
          f"{len(shed)} shed / {len(errors)} errors of {total} requests "
          f"from {args.clients} clients in {dt:.2f}s "
          f"({len(served)/max(dt, 1e-9):.1f} req/s)")
    print(f"[topic_serve] live refresh: {swaps} snapshot swaps under load "
          f"(v{v0} -> v{svc.version}), served from versions {versions}")
    ok = (not errors
          and len(served) + len(shed) == total
          and all(abs(r.theta.sum() - 1.0) < 1e-3 for r in served)
          and swaps >= 1)
    if not ok:
        print("[topic_serve] concurrent phase FAILED")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", action="store_true",
                    help="small end-to-end train/publish/serve smoke")
    ap.add_argument("--device", default="cuda",
                    help="where to train and serve: 'cuda' (default: the "
                         "card) or 'cpu' (the plain PyTorch path)")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--mean-doc-len", type=int, default=80)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--true-topics", type=int, default=20)
    ap.add_argument("-k", "--topics", type=int, default=50)
    ap.add_argument("--sweeps", type=int, default=30)
    ap.add_argument("--mh-steps", type=int, default=2)
    ap.add_argument("--block-tokens", type=int, default=8192)
    ap.add_argument("--hot-words", type=int, default=None,
                    help="training push route: H hottest words dense, cold "
                         "tail as coordinate deltas (default: all dense)")
    ap.add_argument("--staleness", type=int, default=0,
                    help="bounded-staleness executor (same knob as "
                         "repro_torch.launch.lda: 0 = synchronous)")
    ap.add_argument("--model-blocks", type=int, default=0,
                    help="blocked/pipelined executor: pull the model in N "
                         "blocks (same knob as repro_torch.launch.lda)")
    ap.add_argument("--publish-every", type=int, default=10,
                    help="publish a snapshot every N training sweeps")
    ap.add_argument("--serve-docs", type=int, default=32,
                    help="held-out docs to fold in")
    ap.add_argument("--serve-batch", type=int, default=16,
                    help="engine batch rows per fold-in call")
    ap.add_argument("--foldin-sweeps", type=int, default=30)
    ap.add_argument("--foldin-burnin", type=int, default=10)
    ap.add_argument("--queries", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    # concurrent serving plane
    ap.add_argument("--clients", type=int, default=0,
                    help="concurrent client threads driving the admission "
                         "queue (0: skip the concurrent phase; --selftest "
                         "defaults to 4)")
    ap.add_argument("--client-requests", type=int, default=8,
                    help="requests each client thread submits")
    ap.add_argument("--max-delay-ms", type=float, default=5.0,
                    help="batcher latency bound: flush a part-full bucket "
                         "once its oldest request has waited this long")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request SLO: requests still queued past this "
                         "are shed with a typed DeadlineExceeded (0: off)")
    ap.add_argument("--refresh-every", type=int, default=1,
                    help="live-refresh cadence: the background trainer "
                         "publishes a snapshot every N sweeps while the "
                         "engine keeps serving")
    ap.add_argument("--refresh-sweeps", type=int, default=10,
                    help="sweeps the background trainer runs during the "
                         "concurrent phase")
    args = ap.parse_args(argv)
    if not 0 <= args.foldin_burnin < args.foldin_sweeps:
        ap.error(f"--foldin-burnin ({args.foldin_burnin}) must be in "
                 f"[0, --foldin-sweeps) (sweeps={args.foldin_sweeps})")
    if args.publish_every < 0:
        ap.error("--publish-every must be >= 0")
    try:
        resolve_device(args.device)
    except RuntimeError:
        ap.error(f"no CUDA device available for --device {args.device}: "
                 "pass --device cpu to run the plain PyTorch path")

    if args.selftest:
        args.docs = min(args.docs, 400)
        args.vocab = min(args.vocab, 800)
        args.topics = min(args.topics, 10)
        args.true_topics = min(args.true_topics, 8)
        args.sweeps = min(args.sweeps, 15)
        args.block_tokens = min(args.block_tokens, 4096)
        args.publish_every = min(args.publish_every, 5)
        # the selftest always drives the concurrent path
        if args.clients == 0:
            args.clients = 4
        args.refresh_sweeps = min(args.refresh_sweeps, 6)

    return run(args)


if __name__ == "__main__":
    sys.exit(main())
