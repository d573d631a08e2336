"""Run one cell of the benchmark and print its result as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell (``workloads``) names its configuration
(``configs[].file``) and its traffic (``bench/traffic/<traffic>.json``,
whose ``driver`` names the module of ``bench/drivers`` that runs it); the
cell's own limits are in ``bench/workloads/<cell>.json``; each per-layer
metric is read by ``bench/metrics/<metric>.py``.  With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy time and a breakdown.

The run needs CUDA cards, as many as the cell asks for, and the program
under test (``src/repro_torch``); without either it prints no result and
exits with a code other than 0.  It also refuses to print a result when
the JAX package or JAX itself was loaded in this process.

A driver, ``bench/drivers/<driver>.py``, is what a traffic's ``driver``
names, and the harness knows no other part of a cell.  It defines:

* ``CHECKS``, a tuple of the names of the numbers its check compares; the cell's ``bench/workloads/<cell>.json`` gives a limit for
  exactly these names, under ``limits``;
* ``run(cell, seed, seconds, trace, device, t_start, log=..., control=None)``.
  ``cell`` is ``load_cell``'s: the configuration file's object under
  ``config``, the traffic file's under ``traffic``, ``limits``, ``chips``
  and the metric entries.  It makes its inputs from ``seed``, sets up and
  warms every shape, measures for ``seconds`` (traced by the profiler when
  ``trace``), then checks what the window produced against its plain
  reference, after reading the peak memory.  ``t_start`` is the process's
  start, from which ``setup_s`` is counted; ``log`` takes lines for
  standard error; ``control`` names the dtype in which the reference takes
  the program's place (``bench/control.py``'s runs only), a value of its
  ``CONTROL``.  It returns a dict of

  - ``e2e``: each end-to-end metric the cell reports, by name, ``setup_s``
    among them;
  - ``ctx``: what the per-layer readers take: ``trace`` (a
    ``bench.trace.Trace`` of the window, or None untraced), ``spans`` (the
    program's), and the driver's own keys, such as ``sweeps`` and the
    ``shape`` that ``bench/counts`` counts from;
  - ``checks``: ``(name, value, limit)`` for each name of ``CHECKS``; the
    run is ``correct`` when no value is above its limit;
  - ``attempted`` and ``failed``: the window's steps or requests, and
    those that failed;
  - ``memory_peak_bytes``: the peak on the fullest card.

Beside it, ``bench/faults/<driver>.py`` defines the driver's ``CONTROL``,
the dtype one below each precision its configurations may state (for
``train``, bfloat16 below float32), and its ``FAULTS``, each a name mapped
to ``(module, attribute, replacement)``: a function of the program and what
``bench/control.py`` plants in its place.

``train_tokens_per_s``, whatever the driver, is the tokens trained in the
window over the window's length (first timed dispatch to the synchronise
after the last step): for LDA the valid tokens the window's sweeps
resample, for a model the target tokens of the batches trained in the
window, padding excluded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                          # noqa: E402
import importlib                                         # noqa: E402
import importlib.util                                    # noqa: E402
import json                                              # noqa: E402
import os                                                # noqa: E402
import sys                                               # noqa: E402
from pathlib import Path                                 # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(spec: dict, name: str) -> dict:
    """The cell ``name`` of ``spec`` (BENCHMARK.json) with its
    configuration, traffic, limits and metric entries."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{', '.join(sorted(cells))}")
    w = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    shown = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in shown)]
    return {"name": name, "chips": int(w["chips"]),
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(BENCH / "workloads" / f"{name}.json")
            ["limits"],
            "end_to_end": e2e, "per_layer": layer}


def reader(metric: str):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: dict, out: dict, trace: bool, device: dict) -> dict:
    """The last line: the cell's end-to-end or per-layer metrics by name,
    the device, the breakdown of a traced run, and the numbers compared
    with their limits (last)."""
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": all(v <= lim for _, v, lim in out["checks"]),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    tr = out["ctx"].get("trace")
    if trace and tr is not None:
        from bench import trace as trace_mod

        device["busy_s"] = trace_mod.busy_s(tr)
        device["window_s"] = tr.window_s
        line["breakdown"] = trace_mod.breakdown(tr)
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in out["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None,
                    help="judge the control (the reference in this dtype, "
                    "one of the CONTROL of bench/faults/<driver>.py, in "
                    "the program's place) instead of the program; "
                    "bench/control.py's runs, never the benchmark's")
    args = ap.parse_args(argv)

    cell = load_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program under test (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the harness's modules are ``bench.*``, not top-level names of its
    # folder (``bench/trace.py`` would hide the standard library's)
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != BENCH]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    # build caches at fixed paths inside the checkout (the program's own
    # nvcc cache is ``build/kernels``)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    driver = importlib.import_module(
        f"bench.drivers.{cell['traffic']['driver']}")
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START,
                     log=lambda m: print(m, file=sys.stderr, flush=True),
                     control=args.control)
    found = forbidden_modules()
    if found:
        print(f"refusing to report: loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace),
                       {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"]})
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
