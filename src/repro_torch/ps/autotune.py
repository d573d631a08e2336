"""Measured-cost push-route and staleness autotuner (paper section 3.3).

The paper fixes its hybrid push constants by hand -- the hottest 2000
words aggregate densely, everything else ships as per-reassignment
messages, staleness chosen per deployment.  Those constants are workload
facts, not model facts: the right hot/cold boundary depends on the word
frequency skew, the batch size, and how expensive a scatter-applied
coordinate entry is *on this device* relative to a dense row add.  This
module measures instead of guessing, as the JAX package's does:

  1. **Cost model** (``predicted_cost``): every ``PushRoute`` describes its
     traffic shape (``PushRoute.traffic()``).  A two-constant linear model
     over it -- dense cells are cheap adds, coordinate entries expensive
     scatters -- ranks the candidate grid (dense, pure-COO, hybrid at
     power-of-two boundaries) without running anything.
  2. **Measurement** (``measure_routes``): the model's shortlist is timed
     for real -- ``plan`` (the worker-side split) and ``push_plan`` (the
     server-side apply) separately -- on a reassignment batch drawn from
     the *actual* word frequencies of the state being tuned.  Any
     ``ps.push_ms.<route>`` histograms the obs plane already holds are
     folded into the report as observed history.
  3. **Staleness** (``autotune_staleness``): candidate bounds run as real
     executor sweeps and are ranked by measured tokens/s; results are
     bitwise independent of the choice, so the fastest bound wins.

Each function that the JAX package compiles with ``jax.jit`` is called
directly here, after one warm call outside the timed window (on the card
that call builds the kernels).  ``resolve_exec`` is what
``train.async_exec.make_executor`` calls when ``ExecConfig.route`` /
``.staleness`` is the string ``"auto"``: it returns a concrete config plus a
JSON-friendly report, and logs the chosen plan through the obs plane
(``autotune.plan`` span + ``autotune.*`` gauges).

The tiered store's hot-tier sizing (``size_hot_rows``,
``retune_hot_rows``) lives here too, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import rng as jrng
from repro_torch.device import Device, resolve_device
from repro_torch.obs.timing import time_loop
from repro_torch.ps.client import PSClient
from repro_torch.ps.routes import (CooRoute, DenseRoute, HybridRoute,
                                   PushRoute, Reassign, partition_reassign)
from repro_torch.ps.tiered import host

# Relative cost of scatter-applying one coordinate entry vs adding one
# dense cell.  Only used to *rank* candidates before measurement, so the
# exact value is uncritical; the measured pass decides.
SCATTER_VS_DENSE_CELL = 100.0


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """The autotuner's decision plus its evidence."""

    route: PushRoute
    staleness: int
    report: Dict


# ---------------------------------------------------------------------------
# Candidate grid + cost model.
# ---------------------------------------------------------------------------

def candidate_routes(vocab_size: int, *, min_hot: int = 64
                     ) -> List[PushRoute]:
    """Dense, pure-COO, and hybrid at power-of-two hot boundaries from
    ``min_hot`` up to (exclusive) the full vocabulary."""
    cands: List[PushRoute] = [DenseRoute(), CooRoute()]
    h = min_hot
    while h < vocab_size:
        cands.append(HybridRoute(hot_words=h))
        h *= 2
    return cands


def word_frequencies(words, valid=None, vocab_size: Optional[int] = None
                     ) -> np.ndarray:
    """Empirical token counts per word id from a corpus' token stream."""
    w = host(words)
    if valid is not None:
        w = w[host(valid)]
    return np.bincount(w, minlength=vocab_size or 0).astype(np.int64)


def hot_fraction(freq: np.ndarray, hot_words: int) -> float:
    """Fraction of token mass landing on the id prefix ``[0, hot_words)``."""
    total = int(freq.sum())
    if total == 0:
        return 0.0
    return float(freq[: max(hot_words, 0)].sum()) / total


def predicted_cost(route: PushRoute, batch: int, num_rows: int,
                   num_topics: int, freq: np.ndarray) -> float:
    """Rank a route by its modelled *server apply* cost (arbitrary units):
    the word frequencies turn the hybrid's cold *capacity* into an expected
    cold *occupancy*."""
    hw = getattr(route, "hot_words", None)
    hp = None
    if hw is not None:
        hp = int(round(batch * hot_fraction(
            freq, min(max(int(hw), 0), num_rows))))
    t = route.traffic(batch, num_rows, num_topics, hot_prefix=hp)
    dense_cells = t["dense_rows"] * num_topics
    return dense_cells + SCATTER_VS_DENSE_CELL * t["coo_cap"]


# ---------------------------------------------------------------------------
# Measurement.
# ---------------------------------------------------------------------------

def sample_reassign(words, valid, batch: int, num_topics: int,
                    seed: int = 0, *, device: Device = None) -> Reassign:
    """A representative reassignment batch on ``device`` (the card unless
    the caller passes another): rows drawn from the actual token stream (so
    the hot/cold mass is the workload's), topics uniform, every token
    changed.  numpy's ``default_rng(seed)`` makes the JAX package's
    draws."""
    rng = np.random.default_rng(seed)
    w = host(words)
    if valid is not None:
        w = w[host(valid)]
    if w.size == 0:
        w = np.zeros((1,), np.int32)
    rows = rng.choice(w, size=batch).astype(np.int32)
    z_old = rng.integers(0, num_topics, size=batch).astype(np.int32)
    z_new = (z_old + 1 + rng.integers(0, max(num_topics - 1, 1),
                                      size=batch)).astype(np.int32)
    z_new = z_new % num_topics
    device = resolve_device(device)
    r = torch.from_numpy(rows).to(device)
    return Reassign(rows=r, words=r, z_old=torch.from_numpy(z_old).to(device),
                    z_new=torch.from_numpy(z_new).to(device),
                    changed=torch.ones((batch,), dtype=torch.bool,
                                       device=device))


def observed_push_ms() -> Dict[str, Dict]:
    """Per-route ``ps.push_ms.<label>`` history from the installed obs
    metrics registry (empty when no session / no pushes yet)."""
    reg = _obs.metrics_registry()
    if reg is None:
        return {}
    out = {}
    for name, metric in reg.all().items():
        if name.startswith("ps.push_ms.") and getattr(metric, "count", 0):
            out[name[len("ps.push_ms."):]] = metric.summary()
    return out


def measure_routes(handle, re: Reassign, routes: Sequence[PushRoute], *,
                   iters: int = 5, repeats: int = 2) -> List[Dict]:
    """Time plan (worker split) and apply (server scatter/add) per route.

    Hybrid candidates are measured on the *partitioned* batch
    (``partition_reassign``): the cold buffer sized to the tail, the hot
    head aggregated without padding.  Returns one row per route with
    ``plan_ms`` / ``apply_ms`` / ``pushes_per_s`` (apply rate) and the
    traffic dict.
    """
    num_rows, num_topics = handle.num_rows, handle.cols
    batch = int(re.rows.shape[0])
    rows = []
    for route in routes:
        hw = getattr(route, "hot_words", None)
        if hw is None:
            re_r, hp = re, None
        else:
            re_r, hp = partition_reassign(re, min(max(int(hw), 0),
                                                  num_rows))

        def plan_fn(r, _route=route, _hp=hp):
            return _route.plan(r, num_rows, num_topics, prefix_rows=True,
                               hot_prefix=_hp)

        _, t_plan = time_loop(lambda _c, _i, r=re_r, f=plan_fn: f(r),
                              None, iters, repeats=repeats,
                              label=f"autotune.plan.{route.label}")
        plan = plan_fn(re_r)
        _, t_apply = time_loop(
            lambda h, _i, p=plan: h.push_plan(p), handle, iters,
            repeats=repeats, sync=lambda h: h.value,
            label=f"autotune.apply.{route.label}")

        rows.append({
            "route": route.label,
            "hot_words": hw,
            "hot_prefix": hp,
            "plan_ms": t_plan.ms_per_iter(),
            "apply_ms": t_apply.ms_per_iter(),
            "pushes_per_s": t_apply.best_rate(iters),
            "traffic": route.traffic(batch, num_rows, num_topics,
                                     hot_prefix=hp),
        })
    return rows


def autotune_route(words, valid, vocab_size: int, num_topics: int, *,
                   num_shards: int = 1, batch: Optional[int] = None,
                   shortlist: int = 3, iters: int = 5, seed: int = 0,
                   device: Device = None) -> Tuple[PushRoute, Dict]:
    """Pick the push route for a workload: model-rank the grid, measure
    the shortlist (always keeping the pure routes as references) on a
    scratch table on ``device`` (the card unless the caller passes
    another), choose the lowest measured server-apply time."""
    freq = word_frequencies(words, valid, vocab_size)
    batch = int(batch or min(max(int(freq.sum()), 1), 16384))
    cands = candidate_routes(vocab_size)
    ranked = sorted(cands, key=lambda r: predicted_cost(
        r, batch, vocab_size, num_topics, freq))
    keep = list(ranked[:shortlist])
    for ref in (DenseRoute(), CooRoute()):
        if all(r.label != ref.label for r in keep):
            keep.append(ref)

    client = PSClient.create(num_shards=num_shards)
    handle = client.matrix(vocab_size, num_topics, device=device)
    re = sample_reassign(words, valid, batch, num_topics, seed=seed,
                         device=handle.value.device)
    measured = measure_routes(handle, re, keep, iters=iters)
    best = min(measured, key=lambda r: r["apply_ms"])
    winner = next(r for r in keep if r.label == best["route"])
    report = {
        "batch": batch,
        "predicted_order": [r.label for r in ranked],
        "measured": measured,
        "observed_push_ms": observed_push_ms(),
        "chosen_route": best["route"],
    }
    return winner, report


def autotune_staleness(state, cfg, exec_cfg, route: PushRoute, *,
                       candidates: Sequence[int] = (0, 1, 3, 7),
                       iters: int = 2) -> Tuple[int, Dict]:
    """Pick the staleness bound by running each candidate as a real sweep
    of ``state`` (one warm sweep, then ``iters`` timed).  Values are
    bitwise independent of the bound (int adds commute), so measured
    tokens/s is the whole story.  Candidates that round to the same
    effective bound (divisor constraint) are measured once."""
    from repro_torch.train import async_exec

    n_tokens = int(state.valid.sum())
    seen = {}
    key = jrng.PRNGKey(0, state.w.device)
    for s in candidates:
        if exec_cfg.model_blocks > 0:
            _, nb, eff = async_exec.blocked_geometry(
                state.nwk.layout, exec_cfg.model_blocks, s)
        else:
            nb = state.w.shape[0] // cfg.block_tokens
            eff = async_exec.effective_staleness(nb, s)
        if eff in seen:
            continue
        concrete = dataclasses.replace(exec_cfg, staleness=eff, route=route)
        step, _ = async_exec.make_executor(state, cfg, concrete)
        _, t = time_loop(lambda st, _i, f=step: f(st, key), state, iters,
                         repeats=1, sync=lambda st: st.z,
                         label=f"autotune.staleness.{eff}")
        seen[eff] = {"staleness": eff, "sweep_ms": t.ms_per_iter(),
                     "tokens_per_s": t.best_rate(n_tokens)}
    rows = sorted(seen.values(), key=lambda r: r["staleness"])
    best = max(rows, key=lambda r: r["tokens_per_s"])
    return int(best["staleness"]), {"measured": rows,
                                    "chosen_staleness": best["staleness"]}


# ---------------------------------------------------------------------------
# Glue: what make_executor calls for route="auto" / staleness="auto".
# ---------------------------------------------------------------------------

def autotune(state, cfg, exec_cfg) -> TunedPlan:
    """Full pass over whichever knobs the config left to ``"auto"``,
    measured on the device of ``state``."""
    sp = _obs.span("autotune.plan", cat="ps")
    report: Dict = {}

    if exec_cfg.route == "auto":
        route, route_report = autotune_route(
            state.w, state.valid, cfg.V, cfg.K, num_shards=cfg.num_shards,
            batch=cfg.block_tokens, device=state.w.device)
        report["route"] = route_report
    elif exec_cfg.route is not None:
        route = exec_cfg.route
    else:
        from repro_torch.ps.routes import route_for
        route = route_for(exec_cfg.hot_words, cfg.V)

    if exec_cfg.staleness == "auto":
        staleness, s_report = autotune_staleness(
            state, cfg, dataclasses.replace(exec_cfg, staleness=0),
            route)
        report["staleness"] = s_report
    else:
        staleness = int(exec_cfg.staleness)

    report["chosen"] = {"route": route.label,
                        "hot_words": getattr(route, "hot_words", None),
                        "staleness": staleness}
    if sp is not _obs.NULL_SPAN:
        sp.set(**report["chosen"])
        sp.end()
    reg = _obs.metrics_registry()
    if reg is not None:
        hw = getattr(route, "hot_words", None)
        if hw is not None:
            reg.gauge("autotune.hot_words").set(float(hw))
        reg.gauge("autotune.staleness").set(float(staleness))
    return TunedPlan(route=route, staleness=staleness, report=report)


def resolve_exec(state, cfg, exec_cfg):
    """Resolve an ``ExecConfig`` whose route/staleness is ``"auto"`` into
    a concrete config.  Returns ``(concrete_exec_cfg, report)``."""
    plan = autotune(state, cfg, exec_cfg)
    concrete = dataclasses.replace(exec_cfg, route=plan.route,
                                   staleness=plan.staleness)
    return concrete, plan.report


# ---------------------------------------------------------------------------
# Tiered-storage hot-tier sizing (repro_torch.ps.tiered).
# ---------------------------------------------------------------------------

def size_hot_rows(freq: np.ndarray, num_topics: int, *,
                  budget_bytes: Optional[int] = None,
                  target_mass: float = 0.95, min_rows: int = 64) -> int:
    """Initial hot-tier capacity H from the workload's word frequencies.

    Under frequency ordering the cumulative token mass of the id prefix is
    the *expected hit rate* of a prefix-resident hot tier, so H is the
    smallest prefix whose mass reaches ``target_mass`` -- then clamped to
    ``[min_rows, V]`` and (when given) to the device byte budget
    (``H * K * 4 <= budget_bytes``).
    """
    freq = np.asarray(freq, np.int64)
    v = int(freq.size)
    total = int(freq.sum())
    if total == 0:
        h = min_rows
    else:
        mass = np.cumsum(freq, dtype=np.float64) / total
        h = int(np.searchsorted(mass, float(target_mass)) + 1)
    h = min(max(h, min_rows), v)
    if budget_bytes is not None:
        h = min(h, max(int(budget_bytes) // (int(num_topics) * 4), 0))
    return h


def retune_hot_rows(current: int, hit_rate: float, *, vocab_size: int,
                    target: float = 0.9,
                    budget_bytes: Optional[int] = None,
                    num_topics: Optional[int] = None) -> int:
    """Re-size H from the *measured* traffic hit rate (the tiered
    executor's periodic retune): below target, double the hot tier; at or
    above, keep it.  Clamped to the vocabulary and the byte budget like
    ``size_hot_rows``."""
    h = int(current)
    if hit_rate < target:
        h = max(2 * h, 64)
    h = min(h, int(vocab_size))
    if budget_bytes is not None and num_topics:
        h = min(h, max(int(budget_bytes) // (int(num_topics) * 4), 0))
    return h
