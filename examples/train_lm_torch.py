"""End-to-end LM training driver on the PyTorch port: a ~100M-parameter
dense model trained for a few hundred steps on the synthetic Markov-Zipf
stream, demonstrating the full substrate (data pipeline -> model -> AdamW
-> checkpoint) with the paper's cyclic vocab-sharded embedding as a
first-class feature.  The twin of ``examples/train_lm.py``: the same
launcher argv, through ``repro_torch.launch.train``.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 300          # card
  PYTHONPATH=src python examples/train_lm_torch.py --small --device cpu # CPU

On the CPU a 100M model is slow; --small runs a 20M variant that visibly
converges in a few minutes.  It runs on the card unless ``--device cpu``
asks for the CPU; with no card and no ``--device cpu`` the launcher exits
2 with the port's device message.  On a mesh of rank processes, add
``--mesh host``.
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SMALL_ARGV = ["-m", "repro_torch.launch.train",
              "--arch", "yi-6b", "--smoke", "--steps", "{steps}",
              "--batch", "16", "--seq", "128", "--lr", "1e-3"]
FULL_ARGV = ["-m", "repro_torch.launch.train",
             "--preset", "lm100m", "--steps", "{steps}",
             "--batch", "4", "--seq", "256", "--lr", "6e-4"]


def command(steps="300", small=False, device="cuda", extra=()):
    """The launcher's command line: ``steps`` steps of the 20M variant
    (``small``) or of lm100m, on ``device``."""
    argv = [a.format(steps=steps) for a in (SMALL_ARGV if small
                                              else FULL_ARGV)]
    return [sys.executable, *argv, "--device", device, *extra]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", default="300")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args, extra = ap.parse_known_args()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    raise SystemExit(subprocess.call(
        command(args.steps, args.small, args.device, extra), env=env,
        cwd=ROOT))
