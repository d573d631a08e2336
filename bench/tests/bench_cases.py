"""Shared pieces of the benchmark's tests: paths, and a training cell small
enough for the CPU, whose program runs the plain PyTorch versions of the
kernels."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

LIMITS = {"init_z": 0, "sweep_z": 0, "counts": 0}


def tiny_cell(vocab: int = 400, topics: int = 16, docs: int = 60,
              model_blocks: int = 16) -> dict:
    """A training cell at a CPU size, the shape of ``pipelined``'s."""
    return {
        "config": {"num_topics": topics, "vocab_size": vocab, "alpha": 0.1,
                   "beta": 0.01, "mh_steps": 2},
        "traffic": {"driver": "train",
                    "corpus": {"structure_seed": 0, "docs": docs,
                               "mean_doc_len": 30, "min_doc_len": 4,
                               "zipf": 1.05,
                               "true_topics": 8, "doc_topic_alpha": 0.08,
                               "home_share": 0.8},
                    "job": {"model_blocks": model_blocks, "staleness": 1,
                            "hot_words": 50},
                    "warm_sweeps": 1},
        "limits": dict(LIMITS),
    }


def run_tiny(cell: dict, seed: int, seconds: float = 0.3,
             trace: bool = False, control=None) -> dict:
    from bench.drivers import train

    return train.run(cell, seed, seconds, trace, torch.device("cpu"),
                     time.perf_counter(), control=control)


def correct(out: dict) -> bool:
    return all(v <= lim for _, v, lim in out["checks"])
