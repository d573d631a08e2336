"""The ``lm_train`` driver at a CPU size: a sound run reads ``correct``,
the float8 control and each planted fault read it false; its batches, its
FLOP count and its readers by hand; the spec with the LM's entries breaks
no rule."""
from __future__ import annotations

import json
import time

import pytest
import torch

from bench_cases import ROOT
from bench import run
from bench.counts import deepseek_v2 as counts, peaks
from bench.drivers import lm_train
from bench.faults import lm_train as faults
from bench.trace import Trace
from spec_rules import spec_problems

CELL = "train-dsv2lite-ep8-4k"
CONFIG = json.loads((ROOT / "bench" / "configs"
                     / "deepseek-v2-lite-ep8.json").read_text())
# the program in float32 at this size reads loss 0, grads under 2e-6 and
# update under 1e-4 (the float32 rounding of p - lr * delta); in bf16, with
# 16 tokens an expert, one flipped route moves an expert's gradient by
# a tenth, so the sound runs here are float32's and the control's
# precision is the cell's
TINY_LIMITS = {"loss": 1e-4, "grads": 0.01, "update": 0.01}


def tiny_cell(precision: str = "float32") -> dict:
    """The cell's configuration at small widths (the published keys, the
    cut's share of 4 of 16 experts) and a batch of 4 rows of 64."""
    config = dict(CONFIG, precision=precision, hidden_size=64,
                  num_attention_heads=4,
                  kv_lora_rank=32, qk_rope_head_dim=16, qk_nope_head_dim=32,
                  v_head_dim=32, intermediate_size=128,
                  moe_intermediate_size=32, n_routed_experts=4,
                  num_hidden_layers=3, vocab_size=256,
                  published=dict(CONFIG["published"], n_routed_experts=16))
    traffic = {"driver": "lm_train",
               "batch": {"rows": 4, "seq_len": 64, "zipf": 1.0,
                         "structure_seed": 0, "batches": 2},
               "weights_seed": 5, "microbatch": 2, "warm_steps": 1}
    return {"config": config, "traffic": traffic,
            "limits": dict(TINY_LIMITS)}


def run_tiny(seed: int, trace: bool = False, control=None,
             precision: str = "float32") -> dict:
    return lm_train.run(tiny_cell(precision), seed, 0.2, trace,
                        torch.device("cpu"), time.perf_counter(),
                        control=control)


def correct(out: dict) -> bool:
    return all(v <= lim for _, v, lim in out["checks"])


def test_a_sound_run_is_correct():
    out = run_tiny(31)
    assert correct(out), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["e2e"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_reads_incorrect(monkeypatch, fault):
    monkeypatch.setattr(*faults.FAULTS[fault])
    out = run_tiny(32)
    assert not correct(out), out["checks"]


def test_control_in_float8_reads_incorrect():
    assert faults.CONTROL == {"bfloat16": "float8_e4m3fn"}
    out = run_tiny(33, control=faults.CONTROL["bfloat16"],
                   precision="bfloat16")
    assert not correct(out), out["checks"]


def test_batches_follow_the_seed_and_pack_the_next_ids():
    traffic = tiny_cell()["traffic"]
    a = lm_train.make_batches(traffic, 256, 7, torch.device("cpu"))
    b = lm_train.make_batches(traffic, 256, 7, torch.device("cpu"))
    c = lm_train.make_batches(traffic, 256, 8, torch.device("cpu"))
    assert all(torch.equal(x[0], y[0]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    tok, tgt = a[0]
    assert tok.shape == tgt.shape == (4, 64)
    flat_tok, flat_tgt = tok.reshape(-1), tgt.reshape(-1)
    assert torch.equal(flat_tok[1:], flat_tgt[:-1])    # packed end to end
    assert 0 <= int(tok.min()) and int(tok.max()) < 256
    # Zipf(1): the id at rank 0 is the commonest
    perm = torch.randperm(256, generator=torch.Generator().manual_seed(0))
    ids = torch.cat([x[0].reshape(-1) for x in a])
    assert int(torch.bincount(ids, minlength=256).argmax()) == int(perm[0])


def test_flops_by_hand():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "qk_nope_head_dim": 3, "qk_rope_head_dim": 1, "v_head_dim": 2,
           "kv_lora_rank": 4, "num_hidden_layers": 3,
           "first_k_dense_replace": 1, "n_routed_experts": 2,
           "published": {"n_routed_experts": 8},
           "moe_intermediate_size": 5, "intermediate_size": 7,
           "n_shared_experts": 2, "vocab_size": 11}
    # a token: MLA 8*2*4 + 8*5 + 4*2*5 + 2*2*8 = 176 a layer; the dense
    # FFN 3*8*7; a router 8*8 and shared 3*8*10 in each of 2 MoE layers;
    # the head 8*11.  Attention: 2 rows of 3, 2 heads, 6 causal pairs a
    # head, (3 + 1) + 2 a pair; 10 held pairs of 3*8*5.
    per_token = 3 * 176 + 168 + 2 * (64 + 240) + 88
    attn = 3 * (2 * 2 * 6) * 6
    want = 2 * (6 * per_token + attn + 10 * 120)
    assert counts.forward_flops(cfg, 2, 3, 10) == want
    assert counts.step_flops(cfg, 2, 3, 10) == 3 * want


def _ev(name, ts, dur, cat="cuda"):
    return {"name": name, "ph": "X", "cat": cat, "ts": float(ts),
            "dur": float(dur)}


def test_readers_by_hand():
    evs = [_ev("lm.step.device", 0, 1000), _ev("lm.step.device", 2000, 3000),
           _ev("lm.attn", 10, 100), _ev("lm.attn.bwd", 200, 300),
           _ev("lm.moe.route", 500, 10), _ev("lm.moe.experts", 510, 20),
           _ev("lm.moe.combine", 530, 30), _ev("lm.moe.bwd", 2100, 140),
           _ev("lm.optimizer", 4500, 400),
           _ev("lm.attn", 0, 999, cat="exec"),       # a host span: not read
           {"name": "lm.moe.held_pairs", "ph": "C", "args": {"pairs": 6}},
           {"name": "lm.moe.held_pairs", "ph": "C", "args": {"pairs": 10}}]
    shape = {"config": {"hidden_size": 8, "num_attention_heads": 2,
                        "qk_nope_head_dim": 3, "qk_rope_head_dim": 1,
                        "v_head_dim": 2, "kv_lora_rank": 4,
                        "num_hidden_layers": 3, "first_k_dense_replace": 1,
                        "n_routed_experts": 2, "moe_intermediate_size": 5,
                        "intermediate_size": 7, "n_shared_experts": 2,
                        "vocab_size": 11}, "rows": 2, "seq_len": 3}
    trace = Trace([("k", 0.0, 50.0), ("k", 60.0, 100.0)], [], (0.0, 200.0))
    ctx = {"trace": trace, "spans": evs, "steps": 2, "shape": shape}
    assert run.reader("lm.attn_share")(ctx) == pytest.approx(10.0)
    assert run.reader("lm.moe_share")(ctx) == pytest.approx(5.0)
    assert run.reader("lm.optimizer_share")(ctx) == pytest.approx(10.0)
    assert run.reader("lm.step_device_ms")(ctx) == pytest.approx(2.0)
    assert run.reader("lm.device_idle")(ctx) == pytest.approx(55.0)
    assert run.reader("lm.kernels_per_step")(ctx) == pytest.approx(1.0)
    flops = sum(counts.step_flops(shape["config"], 2, 3, p) for p in (6, 10))
    assert run.reader("lm.mfu")(ctx) == pytest.approx(
        100 * flops / (200e-6 * peaks.BF16_FLOPS_PER_S))
    # a step without its counter (a program that does not count) reads
    # no MFU
    assert run.reader("lm.mfu")(dict(ctx, spans=evs[:-1])) is None


def test_a_traced_cpu_run_reads_its_shares():
    """The program's spans of a CPU run, put under the card's ``cat``:
    the parts the shares read lie inside the steps, and the held pairs
    are counted once a step."""
    out = run_tiny(34, trace=True)
    c = out["ctx"]
    card = dict(c, spans=[dict(e, cat="cuda") if e.get("cat") == "cpu"
                          else e for e in c["spans"]])
    shares = [run.reader(m)(card) for m in ("lm.attn_share", "lm.moe_share",
                                            "lm.optimizer_share")]
    assert all(0 < s < 100 for s in shares) and sum(shares) < 100
    pairs = [e for e in c["spans"] if e.get("name") == "lm.moe.held_pairs"]
    assert len(pairs) == c["steps"]
    assert run.reader("lm.step_device_ms")(card) > 0


def test_the_spec_with_the_lm_breaks_no_rule():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert spec_problems(spec, ROOT) == []
    cell = run.load_cell(spec, CELL)
    assert cell["chips"] == 1
    assert set(cell["limits"]) == set(lm_train.CHECKS)
    assert {m["name"] for m in cell["per_layer"]} == {
        "lm.mfu", "lm.step_device_ms", "lm.moe_share", "lm.attn_share",
        "lm.optimizer_share", "lm.device_idle", "lm.kernels_per_step"}
    # the configuration's file is the catalog's keys, the cut ones cut
    cfg = cell["config"]
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"],
            cfg["vocab_size"]) == (9, 8, 12800)
    assert cfg["published"] == {"num_hidden_layers": 27,
                                "n_routed_experts": 64, "vocab_size": 102400}
    model = lm_train.model_config(cfg)
    assert (model.num_experts, model.held_experts_, model.num_layers,
            model.vocab_size, model.d_model, model.moe_d_ff) == (
        64, 8, 9, 12800, 2048, 1408)
