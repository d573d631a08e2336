"""Batched serving demo on the PyTorch port: prefill + cached decode with
the engine, on a smoke-scale gemma3 (sliding-window + global layers --
both cache paths).  The twin of ``examples/serve_lm.py``: the same
launcher argv, through ``repro_torch.launch.serve``.  The port draws the
weights from a ``torch.Generator`` of the seed, so its sampled tokens are
not the JAX package's.

  PYTHONPATH=src python examples/serve_lm_torch.py               # card
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu  # CPU

It runs on the card unless ``--device cpu`` asks for the CPU; with no
card and no ``--device cpu`` the launcher exits 2 with the port's device
message.  Other arguments pass through to the launcher.
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

ARGV = ["-m", "repro_torch.launch.serve",
        "--arch", "gemma3-4b", "--smoke", "--batch", "8",
        "--prompt-len", "32", "--gen", "48", "--temperature", "0.8"]


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
