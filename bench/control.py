"""The control of a cell's check, and its planted faults, at the cell's own
size, each through the harness's own run and ``correct``.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        --plant control,unchanged,half_the_batch --seconds 1

Both belong to the cell's driver and are found by its name, in
``bench/faults/<driver>.py``.  ``control`` is the control: the reference in
the program's place, computed in the dtype that the module's ``CONTROL``
gives for the configuration's precision, one below it
(``bench/run.py --control <dtype>``).  Every other name is a fault of the
module's ``FAULTS``, planted in the program for the run.  For each seed and
plant, one run of ``bench/run.py`` in this process; its result line is
printed as it comes, with the plant and the seed, and has to read
``correct`` false.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--plant", default="control")
    ap.add_argument("--seconds", default="1")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != ROOT / "bench"]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import run

    cell = run.load_cell(run.load_json(ROOT / "BENCHMARK.json"),
                         args.workload)
    faults = importlib.import_module(
        f"bench.faults.{cell['traffic']['driver']}")
    rc = 0
    for seed in args.seeds.split(","):
        for plant in args.plant.split(","):
            cmd = ["--workload", args.workload, "--seed", seed,
                   "--seconds", args.seconds, "--trace", "0"]
            patch = contextlib.nullcontext()
            if plant == "control":
                cmd += ["--control",
                        faults.CONTROL[cell["config"]["precision"]]]
            else:
                mod, attr, fn = faults.FAULTS[plant]
                patch = _planted(mod, attr, fn)
            buf = io.StringIO()
            with patch, contextlib.redirect_stdout(buf):
                code = run.main(cmd)
            lines = buf.getvalue().strip().splitlines()
            line = json.loads(lines[-1]) if code == 0 and lines else None
            print(json.dumps({"workload": args.workload, "plant": plant,
                              "seed": int(seed), "rc": code,
                              "correct": line and line["correct"],
                              "checks": line and line["checks"]}),
                  flush=True)
            rc |= code != 0 or line["correct"] is not False
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return int(rc)


@contextlib.contextmanager
def _planted(mod, attr, fn):
    real = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, real)


if __name__ == "__main__":
    sys.exit(main())
