"""BENCHMARK.json and the files the harness finds by name in it."""
from __future__ import annotations

import json
import re

import pytest

from bench_cases import ROOT
from bench import run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_their_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == want, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_configs_files_and_reduced_keys():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("bench/")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"]
        assert cfg["precision"] == "float32"
        assert c["reduced"] == []
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    got = run.load_cell(SPEC, cell)
    assert got["chips"] == 1
    assert got["traffic"]["driver"] == "train"
    assert set(got["limits"]) == {"init_z", "sweep_z", "counts"}
    assert {m["name"] for m in got["end_to_end"]} == {"train_tokens_per_s",
                                                      "setup_s"}
    assert got["per_layer"]
    for m in got["per_layer"]:
        assert callable(run.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_lists_its_kernels(metric):
    path = ROOT / "bench" / "metrics" / f"{metric}.py"
    text = path.read_text()
    assert "KERNELS = " in text and "def read(ctx)" in text
    # a reader with nothing to read returns nothing
    assert run.reader(metric)({"trace": None, "spans": [], "sweeps": 0,
                               "shape": {}}) is None


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell(SPEC, "no-such-cell")

