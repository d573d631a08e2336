"""Topic-serving demo on the PyTorch port: train a small LDA model,
publish versioned snapshots while training, then fold in held-out
documents through the batched query engine and rank them with
topic-smoothed query likelihood (the train -> snapshot -> serve path of
DESIGN.md section 3).  The twin of ``examples/serve_topics.py``: the same
launcher argv, through ``repro_torch.launch.topic_serve``.

  PYTHONPATH=src python examples/serve_topics_torch.py               # card
  PYTHONPATH=src python examples/serve_topics_torch.py --device cpu  # CPU

It runs on the card unless ``--device cpu`` asks for the plain PyTorch
path; with no card and no ``--device cpu`` the launcher exits 2 with the
port's device message.  Other arguments pass through to the launcher.
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

ARGV = ["-m", "repro_torch.launch.topic_serve",
        "--docs", "600", "--vocab", "1000", "-k", "16",
        "--true-topics", "10", "--sweeps", "20", "--publish-every", "5",
        "--serve-docs", "48", "--serve-batch", "16", "--queries", "4"]


def command(device="cuda", extra=()):
    """The launcher's command line on ``device``."""
    return [sys.executable, *ARGV, "--device", device, *extra]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args, extra = ap.parse_known_args()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    raise SystemExit(subprocess.call(command(args.device, extra), env=env,
                                     cwd=ROOT))
