"""Distributed LDA on the PyTorch port: the paper's architecture on an
SPMD mesh of rank processes.  The twin of ``examples/lda_distributed.py``:
the same launcher argv, through ``repro_torch.launch.lda``.

Workers (all ranks) sample their document partitions; servers (the
model axis) hold cyclic rows of n_wk.  The count tables enter the sweep
as ``repro_torch.ps`` handles on an ``SpmdBackend`` (the launcher is a
thin argv -> ``LDAJob`` translator): pulls are all-gathers over the
server axis, pushes one all-reduce per merge group.  ``--devices 8``
starts 8 rank processes on ``torch.distributed``; on one card they share
it and meet over gloo (``launch.mesh.transport_for`` picks NCCL only where
each rank has a card of its own), and with ``--device cpu`` they run the
plain path on the CPU.

  PYTHONPATH=src python examples/lda_distributed_torch.py               # card
  PYTHONPATH=src python examples/lda_distributed_torch.py --device cpu  # CPU

Without a card and without ``--device cpu`` the launcher exits 2 with the
port's device message.  Other arguments pass through to the launcher.
"""
import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

ARGV = ["-m", "repro_torch.launch.lda",
        "--devices", "8", "--mesh-model", "2",
        "--docs", "600", "--vocab", "1500", "-k", "30",
        "--sweeps", "30", "--eval-every", "10",
        # hybrid push route: hottest 200 words dense, cold tail as
        # coordinate deltas (paper section 3.3)
        "--staleness", "2", "--hot-words", "200"]


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
