"""Out-of-core streaming training on the PyTorch port, end to end --
including a simulated preemption and a bitwise resume, all through
``repro_torch.api``.  The twin of ``examples/stream_train.py``: the same
corpus, shards, jobs and seeds.

The paper's Web-scale story is that the *corpus* never fits anywhere:
data is partitioned and streams past the parameter servers while only
the model (the count tables) is global.  This example builds a sharded
on-disk stream, trains a few epochs with mid-epoch checkpoints
(``CheckpointPolicy`` -> ``CheckpointCallback`` under the hood),
"crashes", and resumes -- then proves the interruption was invisible by
rebuilding the counts from the persisted assignments (the paper's
section-3.5 recovery).

  PYTHONPATH=src python examples/stream_train_torch.py               # card
  PYTHONPATH=src python examples/stream_train_torch.py --device cpu  # CPU

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
path; with no card and no ``--device cpu`` it stops with the port's
device message.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np

from repro_torch import api
from repro_torch.data import corpus as corpus_mod
from repro_torch.data import stream as stream_mod


def main(device=None):
    """Run the example on ``device`` (None: the card); returns the resumed
    run's fitted model."""
    device = api.resolve_device(device)
    work = tempfile.mkdtemp(prefix="lda_stream_")
    stream_dir = os.path.join(work, "stream")
    ckpt = os.path.join(work, "ckpt.npz")

    # 1. Offline ingestion pass: shard the corpus onto disk.  Memory is
    #    bounded by one shard regardless of corpus size -- at Web scale
    #    this writer runs on CPU feeder hosts over the real collection.
    corp = corpus_mod.synthetic_corpus(600, 1500, true_topics=10,
                                       mean_doc_len=60)
    meta = stream_mod.write_sharded(stream_dir, corp,
                                    tokens_per_shard=8192)
    print(f"stream: {meta.num_tokens} tokens in {meta.num_shards} shards "
          f"of {meta.tokens_per_shard} (doc cap {meta.doc_cap})")

    # 2. One declarative job covers the whole scenario: streamed source,
    #    bounded-staleness executor, checkpoint every 2 shard visits.
    #    ``max_shards=3`` simulates a mid-epoch preemption.
    base = dict(stream_dir=stream_dir, num_topics=20, block_tokens=2048,
                num_shards=4, staleness=1, epochs=3, seed=0, eval_every=2)

    print("\n--- run, interrupted mid-epoch after 3 shard visits ---")
    api.APSLDA(api.LDAJob(
        checkpoint=api.CheckpointPolicy(path=ckpt, every=2),
        max_shards=3, **base), device=device).fit()

    print("\n--- resumed from the checkpoint (bitwise continuation) ---")
    job = api.LDAJob(
        checkpoint=api.CheckpointPolicy(path=ckpt, resume=True),
        **{**base, "eval_every": 4})
    model = api.APSLDA(job, device=device).fit()

    # 3. The conservation oracle: counts rebuilt from the persisted z
    #    files must equal the fitted model exactly (exactly-once pushes).
    reader = stream_mod.ShardedCorpusReader(stream_dir)
    nwk_ref, nk_ref = stream_mod.rebuild_counts_from_stream(
        reader, model.num_topics)
    assert np.array_equal(model.nwk, nwk_ref)
    assert np.array_equal(model.nk, nk_ref)
    print(f"\nconservation check OK: PS counts == histogram of the "
          f"{int(nk_ref.sum())} persisted assignments")
    if model.history:
        print(f"final shard perplexity "
              f"{model.history[-1]['perplexity']:.2f}")
    shutil.rmtree(work)
    return model


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the card) or 'cpu' (the plain "
                         "PyTorch path)")
    main(ap.parse_args().device)
