"""Quickstart on the PyTorch port: the paper's workload end-to-end through
``repro_torch.api`` -- one declarative job from corpus to served model:
corpus -> fit -> transform -> publish -> score.  The twin of
``examples/quickstart.py``: the same corpus, job and seeds.

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU

It runs on the card (every kernel of the path the hand-written one) unless
``--device cpu`` asks for the plain PyTorch path; with no card and no
``--device cpu`` it stops with the port's device message.

Set ``REPRO_OBS_DIR=somedir`` to trace the run: the fit writes a
Perfetto-loadable ``trace.json`` + ``metrics.jsonl`` there (summarise
with ``python -m repro_torch.launch.obs_report somedir``).  Tracing never
changes results -- the model is bitwise identical either way.
"""
import argparse
import os

import numpy as np

from repro_torch import api
from repro_torch.data import corpus as corpus_mod


def main(device=None):
    """Run the quickstart on ``device`` (None: the card); returns the
    fitted model, θ of the 16 held-out documents and the query scores."""
    device = api.resolve_device(device)
    obs_dir = os.environ.get("REPRO_OBS_DIR", "")
    obs_cfg = (api.ObsConfig(enabled=True, out_dir=obs_dir) if obs_dir
               else api.ObsConfig())
    # 1. A Zipfian corpus with frequency-ordered vocabulary (paper fig. 4 /
    #    section 3.2) -- the stand-in for ClueWeb12 at laptop scale.  The
    #    held-out docs never enter training; they are folded in below.
    corp = corpus_mod.synthetic_corpus(800, 2000, true_topics=12,
                                       mean_doc_len=80, log_fn=print)
    train_corp, held = corpus_mod.train_heldout_split(corp, 0.1, seed=1)

    # 2. The whole run is one declarative job: in-memory source,
    #    in-process backend, bounded-staleness executor, hybrid push route
    #    (paper section 3.3: 100 hottest words dense, cold tail as
    #    (row, col, +/-1) coordinate deltas).
    job = api.LDAJob(corpus=train_corp, num_topics=20, num_shards=4,
                     block_tokens=8192, mh_steps=2,
                     route=api.HybridRoute(hot_words=100),
                     sweeps=60, eval_every=15, seed=0, obs=obs_cfg)

    # 3. Fit.  The estimator drives the executor through the PS client
    #    and returns a frozen TopicModel on ``device``.
    model = api.APSLDA(job, device=device).fit()
    print(f"\nfitted: {model} "
          f"(final perplexity {model.history[-1]['perplexity']:.1f})")

    # 4. Transform: fold unseen documents in against the frozen model
    #    (batched MH inference; alias tables built once per snapshot).
    docs = [held.w[s:s + n] for s, n in
            zip(held.doc_start[:16], held.doc_len[:16])]
    theta = model.transform(docs)
    print(f"transform: theta {theta.shape}, rows sum to "
          f"{theta.sum(axis=1).round(3).min()}..{theta.sum(axis=1).round(3).max()}")

    # 5. Publish: hand the model to the serving stack.  The publisher is
    #    the live train->serve boundary (monotonic snapshot versions).
    pub = model.publisher()
    print(f"published snapshot v{pub.version}")

    # 6. Score: topic-smoothed query likelihood (the paper's IR use
    #    case).  Queries are the most *distinctive* words of the heaviest
    #    topics.
    top = model.top_words(num_words=8)
    print("\ntop words per topic by lift (word ids are frequency ranks):")
    for k in range(min(8, model.num_topics)):
        print(f"  topic {k:2d}: {top[k].tolist()}")
    queries = [top[k][:3].astype(np.int32) for k in range(4)]
    scores = model.score(queries, docs)
    for qi, q in enumerate(queries):
        best = np.argsort(-scores[qi])[:3]
        print(f"  query {q.tolist()}: best docs "
              + ", ".join(f"{d} ({scores[qi, d]:.1f})" for d in best))

    if obs_dir:
        print(f"\ntraced: {obs_cfg.trace_path} (load in Perfetto); "
              f"summary: python -m repro_torch.launch.obs_report {obs_dir}")
    return model, theta, scores


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu' (the plain "
                         "PyTorch path)")
    main(ap.parse_args().device)
