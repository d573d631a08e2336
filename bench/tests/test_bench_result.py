"""The last line's schema, and a run that cannot measure prints nothing."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench_cases import ROOT, run_tiny, tiny_cell
from bench import run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = run.load_cell(SPEC, SPEC["workloads"][0]["name"])
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_untraced_line():
    out = run_tiny(tiny_cell(), seed=7)
    line = run.result_line(CELL, out, False, DEVICE)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {k: {"value": 0, "limit": 0}
                              for k in ("init_z", "sweep_z", "counts")}
    json.dumps(line)


def test_traced_line_on_the_cpu_reads_no_device_metric():
    out = run_tiny(tiny_cell(), seed=8, trace=True)
    line = run.result_line(CELL, out, True, DEVICE)
    # the CPU trace has no device operation: every device reader is silent
    assert set(line["metrics"]) == {"train.dispatch_share"}
    assert 0 < line["metrics"]["train.dispatch_share"]["value"] <= 100
    assert list(line)[-1] == "checks"


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "3", "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, name
