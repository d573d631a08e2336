"""``bench/counts`` against counts made by hand, and the readers that share
them: no layout of the same work can read above 100 %."""
from __future__ import annotations

import importlib.util

import pytest

from bench_cases import ROOT
from bench import trace as tr
from bench.counts import lda, peaks

SHAPE = dict(tokens=10, vocab=6, topics=4, docs=3, mh_steps=2)


def test_hand_counts():
    # 10 tokens, 2 steps: word, doc, topic in (12 B), four randoms a step
    # (32 B), the new topic out (4 B); n_k once (16 B)
    assert lda.mh_sample(**SHAPE) == (0, 120 + 320 + 40 + 16)
    # 6 x 4 entries: weight in, probability and alias out
    assert lda.alias_build(**SHAPE) == (0, 12 * 24)
    # 7 hashes a step, 60 ops a hash; doc ids, 3 docs' offsets and lengths,
    # four randoms a step out
    assert lda.mh_draws(**SHAPE) == (7 * 2 * 60 * 10, 40 + 24 + 320)
    assert lda.delta_push(**SHAPE) == (0, 170)
    assert lda.sweep(**SHAPE) == (7 * 2 * 60 * 10, 160 + 24 + 12 * 24)


def test_int32_peak_from_the_data_sheet():
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    assert peaks.floor_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.floor_s(16.727e12, 1.0) == pytest.approx(1.0, rel=1e-3)


def test_matrix_peaks_from_the_data_sheet():
    # H100 SXM, dense, 700 W: bf16 and fp16 989 T, TF32 495 T, float32
    # outside the tensor cores 67 T
    assert peaks.BF16_FLOPS_PER_S == peaks.FP16_FLOPS_PER_S == 989e12
    assert peaks.TF32_FLOPS_PER_S == 495e12
    assert peaks.FP32_FLOPS_PER_S == 67e12
    assert peaks.floor_s(989e12, 1.0, peak=peaks.BF16_FLOPS_PER_S) == 1.0
    assert peaks.floor_s(1.0, 3.35e12, peak=peaks.BF16_FLOPS_PER_S) == 1.0


@pytest.mark.parametrize("ops,nbytes", [(0, 3.35e12), (16.727e12, 1.0),
                                        (7 * 2 * 60 * 32e6, 1.7e9),
                                        (123456789.0, 987654321.0)])
def test_floor_without_the_keyword_is_the_int32_floor(ops, nbytes):
    # every LDA roofline and train.mfu reads bit for bit what it read
    # before the keyword came
    want = max(ops / (132 * 64 * 1.98e9), nbytes / 3.35e12)
    assert peaks.floor_s(ops, nbytes) == want
    assert peaks.floor_s(ops, nbytes, peak=peaks.INT32_OPS_PER_S) == want


def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(kernels, window_us):
    return tr.Trace([(n, s, e) for n, s, e in kernels], [], (0.0, window_us))


@pytest.mark.parametrize("padding", [0, 1, 7])
def test_roofline_counts_valid_tokens_whatever_the_padding(padding):
    # the same work laid out with more padded slots takes longer and reads
    # a lower share; the count never grows with the padding
    mod = _reader("train.mh_sample_roofline")
    shape = dict(SHAPE, tokens=1_000_000)
    floor_us = peaks.floor_s(*lda.mh_sample(**shape)) * 1e6
    took = floor_us * (1 + padding)
    ctx = {"trace": _trace([("void mh_sample_kernel(Params)", 0, took)],
                           took * 2), "sweeps": 1, "shape": shape}
    assert mod.read(ctx) == pytest.approx(100.0 / (1 + padding))


def test_mfu_at_the_floor_reads_100():
    mod = _reader("train.mfu")
    shape = dict(SHAPE, tokens=1_000_000, vocab=1000, topics=100)
    floor_us = peaks.floor_s(*lda.sweep(**shape)) * 1e6
    ctx = {"trace": _trace([("k", 0, floor_us)], 3 * floor_us),
           "sweeps": 3, "shape": shape}
    assert mod.read(ctx) == pytest.approx(100.0)


def test_trace_union_idle_and_breakdown():
    t = tr.Trace([("void a<int>(x)", 0, 10), ("b", 5, 20), ("a", 30, 40)],
                 [("bench.sweep", 0, 50), ("aten::index", 18, 35)],
                 (0.0, 50.0))
    assert tr.busy_s(t) == pytest.approx(30e-6)
    assert tr.idle_gaps(t) == [(20, 30), (40, 50)]
    assert tr.device_s(t, ["a"]) == pytest.approx(20e-6)
    got = tr.breakdown(t)
    assert got["device_ops"][0] == ["a", pytest.approx(20e-6)]
    assert dict((n, v) for n, v in got["idle_gaps"]) == {
        "aten::index": pytest.approx(10e-6),
        "bench.sweep": pytest.approx(10e-6)}
    assert _reader("train.device_idle").read(
        {"trace": t}) == pytest.approx(40.0)
    assert _reader("train.kernels_per_sweep").read(
        {"trace": t, "sweeps": 2}) == pytest.approx(1.5)


def test_parse_clips_to_the_window():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 90, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 140,
         "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 200, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 101,
         "dur": 2},
    ]
    t = tr.parse(events)
    assert t.window == (100.0, 150.0)
    assert t.device == [("k", 100.0, 110.0), ("Memcpy DtoD", 140.0, 150.0)]
    assert t.host == [("aten::add", 101.0, 103.0)]
    assert tr.parse(events[1:]) is None
