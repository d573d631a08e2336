"""The LM training driver: ``repro_torch``'s training step of a published
model at one device's share (``configs.deepseek_v2_lite_16b.published``),
timed step after step, and one more step checked against the plain
reference.

Set-up draws the weights from the traffic's fixed ``weights_seed``
(``train.loop.init_state`` on the card), makes the traffic's batches on
the card from ``seed`` (token ids Zipf over the vocabulary slice, the rank
of each id fixed by ``structure_seed``; rows packed end to end, the
targets the next ids) and runs the warm steps through the step of
``train.loop.make_train_step``.  The window then runs that step on the
batches in turn, back to back, until ``seconds`` have passed, and closes
with a synchronise.

The check comes after the window and its peak memory: the parameters, the
moments and the step count are copied (on the card), the program runs one
more step on the next batch through the step's two halves
(``loop.step_grads``, ``loop.apply_grads``), keeping its loss, gradients
and new parameters, and is freed; the reference
(``bench/reference/deepseek_v2.py``) computes that step's loss, gradients
and update again, in float32, from the saved state and the same batch.
``loss``: the loss's relative difference; ``grads``: the largest over the
leaves of ``|g - g_ref| / |g_ref|``; ``update``: the same of the step's
parameter change.  With ``control`` the numbers judged are the
reference's in that dtype, from the same state.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch

from bench.drivers.train import _Window
from bench.reference import deepseek_v2 as ref

CHECKS = ("loss", "grads", "update")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def model_config(config: dict):
    """The program's configuration of the configuration file: the
    published keys (the cut ones at their published values) cut to the
    file's layers, held experts and vocabulary."""
    from repro_torch.configs import deepseek_v2_lite_16b as ds

    keys = dict(config, **config.get("published", {}))
    return ds.published(keys, num_layers=config["num_hidden_layers"],
                        experts_held=config["n_routed_experts"],
                        vocab_size=config["vocab_size"],
                        dtype=config["precision"],
                        aux_alpha=config["aux_loss_alpha"])


def reference_config(config: dict) -> "ref.Config":
    return ref.config_of(config, config.get("published", {}),
                         config["aux_loss_alpha"])


def make_batches(traffic: dict, vocab: int, seed: int, device
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``batches`` pairs of (tokens, targets) ``[rows, seq_len]``: ids
    drawn Zipf over the ``vocab`` ids, id ``perm[r]`` at rank ``r`` (a
    permutation fixed by ``structure_seed``), packed end to end; the
    draws seeded by ``seed``, on ``device``."""
    b = traffic["batch"]
    rows, seq = int(b["rows"]), int(b["seq_len"])
    perm = torch.randperm(vocab, generator=torch.Generator().manual_seed(
        int(b["structure_seed"]))).to(device)
    weight = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float32,
                                device=device) ** float(b["zipf"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for _ in range(int(b["batches"])):
        ranks = torch.multinomial(weight, rows * seq + 1,
                                  replacement=True, generator=g)
        ids = perm[ranks]
        out.append((ids[:-1].view(rows, seq), ids[1:].view(rows, seq)))
    return out


def opt_settings(tc) -> dict:
    return {"lr": tc.learning_rate, "weight_decay": tc.weight_decay,
            "beta1": tc.beta1, "beta2": tc.beta2, "eps": tc.eps,
            "warmup": tc.warmup_steps, "total": tc.total_steps,
            "clip": tc.grad_clip}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=lambda m: None, control=None) -> dict:
    """One run of an LM training cell: set-up, the window, the check.
    ``control`` (a dtype name) judges the reference in that dtype in the
    program's place."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train import loop

    config, traffic, limits = cell["config"], cell["traffic"], cell["limits"]
    cfg = model_config(config)
    tc = TrainConfig(microbatch=int(traffic["microbatch"]))
    marks = [("start", t_start), ("imported", time.perf_counter())]
    state = loop.init_state(int(traffic["weights_seed"]), cfg,
                            device=device)
    step = loop.make_train_step(cfg, tc)
    batches = make_batches(traffic, cfg.vocab_size, seed, device)
    mask = torch.ones(batches[0][0].shape, dtype=torch.float32,
                      device=device)
    _sync(device)
    marks.append(("weights and batches", time.perf_counter()))
    n = 0
    for _ in range(int(traffic["warm_steps"])):
        state, _ = step(state, *batches[n % len(batches)], mask)
        n += 1
    _sync(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    log(f"[bench] {cfg.name}: {cfg.num_layers} layers, "
        f"{cfg.held_experts_} of {cfg.num_experts} experts, vocabulary "
        f"{cfg.vocab_size}, microbatches {tc.microbatch}; set-up "
        f"{setup_s:.3f} s: " + ", ".join(
            f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])))

    steps = 0
    window = _Window(device) if trace else None
    with window or contextlib.nullcontext():
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.window"):
            while True:
                with torch.profiler.record_function("bench.step"):
                    state, _ = step(state, *batches[n % len(batches)], mask)
                n += 1
                steps += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            _sync(device)
        window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    trace_data, spans = window.read() if window is not None else (None, None)

    t_check = time.perf_counter()
    tokens, targets = batches[n % len(batches)]
    numbers = check(state, tc, tokens, targets, mask, config, control, log)
    del state
    log(f"[bench] {steps} steps in {window_s:.3f} s; check "
        f"{time.perf_counter() - t_check:.3f} s")
    rows, seq = tokens.shape
    return {
        "e2e": {"train_tokens_per_s": steps * rows * seq / window_s,
                "setup_s": setup_s},
        "ctx": {"trace": trace_data, "spans": spans, "steps": steps,
                "shape": {"config": config, "rows": rows, "seq_len": seq}},
        "checks": [(name, numbers[name], limits[name]) for name in CHECKS],
        "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
    }


def _copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: t.detach().clone() for k, t in tensors.items()}


def check(state, tc, tokens, targets, mask, config: dict,
          control=None, log=lambda m: None) -> dict:
    """One more step of the program from ``state``, against the
    reference's from the same state and batch (``state`` is freed).  The
    leaves that read highest go to ``log``."""
    from repro_torch.train import loop

    before = _copy(state.params)
    m, v = _copy(state.opt.m), _copy(state.opt.v)
    count = int(state.opt.step)
    grads, metrics = loop.step_grads(state, max(tc.microbatch, 1), tokens,
                                     targets, mask)
    kept = _copy(grads)
    state, _ = loop.apply_grads(state, grads, tc)
    del grads
    loss = float(metrics["loss"])
    after = _copy(state.params)
    # the program's state leaves the card (the caller holds it no more)
    state.model.to("meta")
    state.opt.m.clear()
    state.opt.v.clear()
    if tokens.device.type == "cuda":
        torch.cuda.empty_cache()

    rcfg = reference_config(config)
    opt = opt_settings(tc)
    want = ref.train_step(before, m, v, count, tokens, targets, rcfg, opt)
    if control is not None:
        got = ref.train_step(before, m, v, count, tokens, targets, rcfg, opt,
                             dtype=getattr(torch, control))
        loss, kept, after = float(got[0]), got[1], got[2]
    r_loss, r_grads, r_new = want

    def rel(a, b):
        return float((a.float() - b).norm()
                     / torch.clamp(b.norm(), min=1e-30))

    grad = {k: rel(kept[k], r_grads[k]) for k in r_grads}
    update = {k: rel(after[k].float() - before[k].float(),
                     r_new[k] - before[k].float()) for k in r_new}
    for name, by in (("grads", grad), ("update", update)):
        top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
        log(f"[bench] {name} highest: " + ", ".join(
            f"{k} {v:.4g}" for k, v in top))
    return {"loss": abs(loss - float(r_loss)) / abs(float(r_loss)),
            "grads": max(grad.values()), "update": max(update.values())}
