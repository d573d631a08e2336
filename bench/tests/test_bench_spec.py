"""BENCHMARK.json and the files the harness finds by name in it, held to
``spec_rules``: the repo's own spec breaks no rule, a tree with a second
driver, its control and faults, and a cut configuration beside the LDA
cells breaks none either, and each rule broken on purpose is reported by
that rule alone, in its own words."""
from __future__ import annotations

import json
import shutil

import pytest

from bench_cases import ROOT
from bench import run
from spec_rules import (NAME, driver_checks, rules_broken, spec_problems)

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _broken(*rules):
    return [p for p in spec_problems(SPEC, ROOT)
            if rules_broken([p]) & set(rules)]


def test_top_level_keys():
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert _broken("top_level") == []


def test_entries_have_their_keys_and_names():
    assert _broken("names", "bounds", "rooflines", "metrics") == []
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        assert all(NAME.match(e["name"]) for e in SPEC[section])


def test_configs_files_and_reduced_keys():
    assert _broken("configs", "cuts", "precision") == []
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(key in cfg.get("published", {}) for key in c["reduced"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    got = run.load_cell(SPEC, cell)
    assert got["chips"] in (1, 4)
    checks = driver_checks(ROOT, got["traffic"]["driver"])
    assert checks and set(got["limits"]) == set(checks)
    shown = {m["name"] for m in got["end_to_end"]}
    assert "setup_s" in shown and len(shown) >= 2
    assert got["per_layer"]
    for m in got["per_layer"]:
        assert m["moves"] in shown
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


def test_the_spec_breaks_no_rule():
    assert spec_problems(SPEC, ROOT) == []


def test_train_driver_checks_read_from_its_source():
    from bench.drivers import train

    assert driver_checks(ROOT, "train") == train.CHECKS == (
        "init_z", "sweep_z", "counts")


def test_train_faults_found_by_the_driver_name():
    from bench.faults import train

    assert train.CONTROL == {"float32": "bfloat16"}
    assert set(train.FAULTS) == {"init_other_key", "unchanged",
                                 "half_the_batch", "merge_left_out",
                                 "token_altered"}


# A stand-in for a model's training cell beside the LDA cells: a second
# driver with checks, a control and a fault of its own, and a bfloat16
# configuration cut as one chip's share: 8 of the published 64 experts, an
# eighth of the vocabulary, the leading dense layer and 4 more.
STUB_DRIVER = '''CHECKS = ("loss", "grad_norm")


def run(cell, seed, seconds, trace, device, t_start, log=None,
        control=None):
    raise NotImplementedError
'''
STUB_FAULTS = '''CONTROL = {"bfloat16": "float8_e4m3fn"}


class Trainer:
    @staticmethod
    def step(state, batch):
        return state


def unchanged(state, batch):
    return state


FAULTS = {"unchanged": (Trainer, "step", unchanged)}
'''
STAND_IN = "moe-stand-in"
STAND_IN_CELL = "moe-stand-in.train"


def _write(path, data):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(data if isinstance(data, str) else json.dumps(data))


def _add_cell(spec, root, name, traffic, chips=1):
    spec["workloads"].append({"name": name, "config": STAND_IN,
                              "traffic": traffic, "chips": chips,
                              "why": "a stand-in cell of a second driver"})
    _write(root / "bench" / "traffic" / f"{traffic}.json",
           {"driver": "stub", "why": "stand-in traffic"})
    _write(root / "bench" / "workloads" / f"{name}.json",
           {"limits": {"loss": 0.01, "grad_norm": 0.05}})


class Tree:
    """A copy of the harness and its spec in a directory of its own, with
    the stand-in cell added."""

    def __init__(self, root, chips=1):
        self.root = root
        shutil.copytree(ROOT / "bench", root / "bench",
                        ignore=shutil.ignore_patterns("tests",
                                                      "__pycache__"))
        self.spec = json.loads(json.dumps(SPEC))
        _write(root / "bench" / "drivers" / "stub.py", STUB_DRIVER)
        _write(root / "bench" / "faults" / "stub.py", STUB_FAULTS)
        self.config = {
            "name": STAND_IN, "precision": "bfloat16", "hidden_size": 2048,
            "num_hidden_layers": 5, "first_k_dense_replace": 1,
            "num_experts": 8, "num_experts_per_tok": 6,
            "num_attention_heads": 16, "vocab_size": 12800,
            "published": {"num_experts": 64, "num_hidden_layers": 27,
                          "vocab_size": 102400},
            "deployment": "8 chips share each layer; this chip holds 8 of "
                          "its 64 experts and an eighth of the vocabulary; "
                          "the layers left out lie on further chips"}
        self.spec["configs"].append({
            "name": STAND_IN, "source": "a stand-in's public config",
            "file": f"bench/configs/{STAND_IN}.json",
            "reduced": ["num_experts", "num_hidden_layers", "vocab_size"],
            "why": "a cut configuration"})
        _add_cell(self.spec, root, STAND_IN_CELL, "stub-train", chips)
        _write(root / "bench" / "metrics" / "train.step_mfu.py",
               "KERNELS = ()\n\n\ndef read(ctx):\n    return None\n")
        self.spec["per_layer"].append({
            "name": "train.step_mfu", "unit": "%", "better": "higher",
            "source": "device_trace", "layer": "whole step",
            "moves": "train_tokens_per_s", "workloads": [STAND_IN_CELL]})

    def problems(self):
        _write(self.root / "bench" / "configs" / f"{STAND_IN}.json",
               self.config)
        _write(self.root / "BENCHMARK.json", json.dumps(self.spec, indent=1))
        return spec_problems(self.spec, self.root)

    def cell(self, name=STAND_IN_CELL):
        return next(w for w in self.spec["workloads"] if w["name"] == name)


@pytest.mark.parametrize("chips", [1, 4])
def test_stand_in_tree_breaks_no_rule(tmp_path, chips):
    tree = Tree(tmp_path, chips)
    assert tree.problems() == []
    assert driver_checks(tmp_path, "stub") == ("loss", "grad_norm")


@pytest.mark.parametrize("key,held", [("num_hidden_layers", 27),
                                      ("num_experts", 64),
                                      ("vocab_size", 102400)])
def test_each_cut_alone_breaks_no_rule(tmp_path, key, held):
    # the stand-in with only one of its cuts; the others back at their
    # published values
    tree = Tree(tmp_path)
    reduced = tree.spec["configs"][-1]["reduced"]
    for other in list(reduced):
        if other != key:
            tree.config[other] = tree.config["published"][other]
            reduced.remove(other)
    assert reduced == [key] and tree.config[key] < held
    assert tree.problems() == []


def _unpublished_cut(tree):
    tree.config["num_attention_heads"] = 8
    tree.spec["configs"][-1]["reduced"].append("num_attention_heads")


def _limits_unlike_checks(tree):
    _write(tree.root / "bench" / "workloads" / f"{STAND_IN_CELL}.json",
           {"limits": {"loss": 0.01}})


def _no_such_driver(tree):
    _write(tree.root / "bench" / "traffic" / "stub-train.json",
           {"driver": "no_such_driver"})


def _two_chips(tree):
    tree.cell()["chips"] = 2


def _second_four_chip_cell(tree):
    # three cells: the two LDA cells and the stand-in
    tree.cell()["chips"] = 4
    tree.spec["workloads"][1]["chips"] = 4


def _float16(tree):
    tree.config["precision"] = "float16"


def _cut_width(tree):
    tree.config["published"]["hidden_size"] = 5120
    tree.spec["configs"][-1]["reduced"].append("hidden_size")


def _cut_without_deployment(tree):
    del tree.config["deployment"]


def _run_without_checks(tree):
    _write(tree.root / "bench" / "drivers" / "stub.py",
           STUB_DRIVER.replace('CHECKS = ("loss", "grad_norm")', ""))


def _no_faults(tree):
    (tree.root / "bench" / "faults" / "stub.py").unlink()


def _control_not_below(tree):
    _write(tree.root / "bench" / "faults" / "stub.py",
           STUB_FAULTS.replace('"float8_e4m3fn"', '"bfloat16"'))


def _fault_of_no_function(tree):
    _write(tree.root / "bench" / "faults" / "stub.py",
           STUB_FAULTS.replace('(Trainer, "step"', '(Trainer, "no_step"'))


def _experts_under_floor(tree):
    tree.config["num_experts"] = 4


def _depth_under_floor(tree):
    tree.config["num_hidden_layers"] = 4


C, W = repr(STAND_IN), repr(STAND_IN_CELL)
FAULTS_FILE = "bench/faults/stub.py"
# case -> (plant, rule, what the rule says)
BROKEN = {
    "reduced-key-unpublished": (
        _unpublished_cut, "cuts",
        f"{C} reduces 'num_attention_heads' with no published value"),
    "limits-unlike-checks": (
        _limits_unlike_checks, "limits",
        f"{W}: limits ['loss'], the driver's CHECKS ['grad_norm', 'loss']"),
    "driver-missing": (
        _no_such_driver, "driver",
        f"{W}: bench/drivers/no_such_driver.py does not load or defines "
        "no run and CHECKS"),
    "chips-2": (_two_chips, "chips", f"{W} asks for 2 chips, not 1 or 4"),
    "second-4-chip-cell-of-3": (
        _second_four_chip_cell, "chips",
        f"2 of 3 cells ask for 4 chips: train-k100-pipelined, "
        f"{STAND_IN_CELL}"),
    "precision-float16": (
        _float16, "precision",
        f"{C} precision 'float16', not one of float32, bfloat16"),
    "reduced-a-width": (
        _cut_width, "cuts",
        f"{C} reduces 'hidden_size', not a cut of depth or of this chip's "
        "share (experts, heads, vocabulary rows)"),
    "cut-without-deployment": (
        _cut_without_deployment, "cuts",
        f"{C} is cut and states no deployment"),
    "driver-without-checks": (
        _run_without_checks, "driver",
        f"{W}: bench/drivers/stub.py does not load or defines no run and "
        "CHECKS"),
    "faults-missing": (
        _no_faults, "faults",
        f"{W}: {FAULTS_FILE} does not load (FileNotFoundError(2, 'No such "
        "file or directory'))"),
    "control-not-below-precision": (
        _control_not_below, "faults",
        f"{W}: {FAULTS_FILE} gives the control 'bfloat16' for bfloat16, "
        "not one of float8_e4m3fn, float8_e5m2, int8"),
    "fault-of-no-function": (
        _fault_of_no_function, "faults",
        f"{W}: {FAULTS_FILE} fault 'unchanged' is not (module, attribute, "
        "replacement) of a function"),
    "experts-under-the-floor": (
        _experts_under_floor, "cuts",
        f"{C} holds 4 of 'num_experts', under its floor 8"),
    "depth-under-the-floor": (
        _depth_under_floor, "cuts",
        f"{C} holds 4 of 'num_hidden_layers', under its floor 5"),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_broken_rule_is_reported_by_its_rule(tmp_path, case):
    plant, rule, said = BROKEN[case]
    tree = Tree(tmp_path)
    plant(tree)
    got = tree.problems()
    assert got == [f"{rule}: {said}"], got
    assert rules_broken(got) == {rule}
