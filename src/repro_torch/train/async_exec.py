"""Asynchronous pipelined training executor (paper sections 2.5, 3.3, 3.4).

Workers sample against a bounded-stale snapshot while pulls and pushes are
in flight, and reassignment deltas are buffered -- the hottest words
aggregated densely, the cold tail shipped as per-reassignment messages.
This module is that schedule, made deterministic, and expressed through the
client API (``repro_torch.ps``): the executor holds ``MatrixHandle`` /
``VectorHandle``s, prefetches through ``PullHandle`` futures and merges a
group in one launch on one process, through the handle's ``PushRoute``
across processes.

**Staleness bound ``s``.**  Block ``i`` samples against a view of ``(n_k,
n_dk, z)`` missing the deltas of the ``s`` most recent blocks -- those
pushes are "in flight".  Block deltas commute (addition, paper section
2.5), so any merge order is exactly-once-correct; ``s = 0`` is the
synchronous schedule and equals ``lightlda.sweep_blocked_ref`` bitwise.
Blocks whose in-flight windows overlap are independent, so each *group* of
``s + 1`` consecutive blocks is resampled in one step and merged at the
group boundary.

**Eager groups.**  The JAX package scans over groups under ``jit``; here a
Python loop runs them, each group a handful of launches on the card: the
threefry draws, the ``mh_sample`` kernel in training mode, and the merge;
the alias tables come from the ``alias_build`` kernel, once per snapshot
sweep or once per pipelined group.  A sweep never writes into the state it
was given: the executor works on its own copies of ``z`` and of the count
tables.

**Group-boundary merge (paper section 3.3).**  On one process
(``ps.InProcessBackend``: every collective moment is the identity) all of
a route's messages end in the executor's own tables, so a group merges
with one ``delta_push`` launch that adds every changed token into ``n_wk``,
``n_dk`` and ``n_k`` at once: no message buffer, no zero-fill, no adds
after.  For any other backend the merge goes through a ``PushRoute`` --
``DenseRoute``, ``CooRoute`` or ``HybridRoute(hot_words=H)`` -- and the
backend's ``reduce``/``gather_concat``.  Every route is integer addition,
so neither the route nor the branch changes results; the route still
shapes every message that ``MatrixHandle.push`` sends.

Entry points:
  * ``pipelined_sweep`` -- the blocked model-parallel executor (worker
    memory O(group x K), the Web-scale path),
  * ``snapshot_sweep``  -- the full-snapshot executor,
  * ``make_executor``   -- the factory ``api.Session`` drives;
  * ``make_stream_executor`` -- the per-shard step of the streamed plane.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import ps
from repro_torch import rng as jrng
from repro_torch.core import lightlda as lda
from repro_torch.kernels import ops
from repro_torch.obs import ObsConfig
from repro_torch.obs.trace import _block


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Executor schedule knobs (orthogonal to the model's ``LDAConfig``).

    ``staleness``: how many block deltas may be in flight while a block
    samples; 0 is the synchronous schedule.  ``route``: the push policy
    (``ps.DenseRoute`` / ``ps.CooRoute`` / ``ps.HybridRoute``);
    ``hot_words`` is the scalar knob mapped through ``ps.route_for`` when
    ``route`` is None.  The JAX package's ``"auto"`` for either belongs to
    the autotuner, which is not ported yet.  ``model_blocks``: > 0 selects
    the blocked executor with the model pulled in that many blocks, 0 the
    full-snapshot executor.  ``obs``: telemetry tri-state (None inherits
    the installed session); observation only.
    """

    staleness: Union[int, str] = 0
    hot_words: Optional[int] = None
    model_blocks: int = 0
    route: Optional[Union[ps.PushRoute, str]] = None
    obs: Optional[ObsConfig] = None

    def wants_autotune(self) -> bool:
        return self.route == "auto" or self.staleness == "auto"

    def resolve_route(self, vocab_size: int) -> ps.PushRoute:
        if self.wants_autotune():
            raise ValueError(
                "route='auto'/staleness='auto' needs the autotuner "
                "(ps.autotune), which is not ported yet: ROADMAP A, "
                "'Autotuner'; "
                "pass a ps.PushRoute and an int")
        if self.route is not None:
            return self.route
        return ps.route_for(self.hot_words, vocab_size)


def effective_staleness(n_blocks: int, staleness: int) -> int:
    """Largest usable bound <= ``staleness``: the group size ``s + 1`` must
    divide the block count, so the bound is rounded down to a divisor."""
    s = max(0, min(int(staleness), n_blocks - 1))
    while s > 0 and n_blocks % (s + 1):
        s -= 1
    return s


# ---------------------------------------------------------------------------
# Shared pieces.
# ---------------------------------------------------------------------------

def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=like.device)


def token_deltas(d_b, z_old, z_new, changed, num_docs: int, num_topics: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The worker-local halves of a reassignment batch: (d_nk [K], d_ndk
    [num_docs, K]).  These never route -- ``n_k`` reduces over workers,
    ``n_dk`` stays with the document's owner (paper section 3)."""
    amt = changed.to(torch.int32)
    zo, zn = z_old.long(), z_new.long()
    d_nk = (_zeros((num_topics,), amt)
            .index_put_((zo,), -amt, accumulate=True)
            .index_put_((zn,), amt, accumulate=True))
    dl = d_b.long()
    d_ndk = (_zeros((num_docs, num_topics), amt)
             .index_put_((dl, zo), -amt, accumulate=True)
             .index_put_((dl, zn), amt, accumulate=True))
    return d_nk, d_ndk


def hybrid_count_deltas(w_b, d_b, z_old, z_new, valid_b, num_docs: int,
                        hot_words: int, cfg: "lda.LDAConfig"
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-level count deltas (d_nwk [V, K], d_nk [K], d_ndk [D, K]) with
    the route ``ps.route_for(hot_words)`` picks; the same values for every
    ``hot_words``."""
    changed = (z_old != z_new) & valid_b
    route = ps.route_for(hot_words, cfg.V)
    d_nwk = route.block_delta(ps.Reassign(w_b, w_b, z_old, z_new, changed),
                              cfg.V, cfg.K, prefix_rows=True)
    d_nk, d_ndk = token_deltas(d_b, z_old, z_new, changed, num_docs, cfg.K)
    return d_nwk, d_nk, d_ndk


def merges_in_one_launch(handle: "ps.MatrixHandle") -> bool:
    """Whether a group merges with one ``delta_push`` launch: the handle's
    backend is the in-process one, whose moments are all the identity, so
    the route's messages would all end in the executor's own tables.  Any
    other backend gets the routed merge."""
    return isinstance(handle.client.backend, ps.InProcessBackend)


def routed_merge_snapshot(route: ps.PushRoute, backend, nwk_dense, nk, ndk,
                          w_b, d_b, z0, z_new, changed, num_topics: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A snapshot group's merge through ``route`` and ``backend``'s
    moments: the dense part (the hybrid's ``[H, K]`` hot prefix) added onto
    the first ``H`` rows of ``nwk_dense`` and the coordinate part applied by
    ``delta_apply_coo``, both in place; ``n_k``/``n_dk`` take
    ``token_deltas``.  Returns the new ``(nk, ndk)``."""
    plan = route.plan(ps.Reassign(rows=w_b, words=w_b, z_old=z0,
                                  z_new=z_new, changed=changed),
                      nwk_dense.shape[0], num_topics, prefix_rows=True)
    d_nk, d_ndk = token_deltas(d_b, z0, z_new, changed, ndk.shape[0],
                               num_topics)
    if plan.dense is not None:
        d = backend.reduce(plan.dense)
        nwk_dense[:d.shape[0]] += d
    if plan.coo is not None:
        c_rows, c_cols, c_vals = (backend.gather_concat(x) for x in plan.coo)
        ops.delta_apply_coo(c_rows, c_cols, c_vals, nwk_dense.shape[0],
                            num_topics, out=nwk_dense)
    # n_dk stays local (paper section 3)
    return nk + backend.reduce(d_nk), ndk + d_ndk


def routed_merge_block(route: ps.PushRoute, rows, nk, ndk, local, words,
                       d_b, z0, z_new, changed, num_topics: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A pipelined group's merge through ``route``: the group-local delta
    of the pulled ``rows`` (block-local ids ``local``) materialised and
    added onto them, ``n_k``/``n_dk`` by duplicate-tolerant adds.  Returns
    the new ``(rows, nk, ndk)``."""
    d_rows = route.block_delta(
        ps.Reassign(rows=local, words=words, z_old=z0, z_new=z_new,
                    changed=changed), rows.shape[0], num_topics)
    amt = changed.to(torch.int32)
    zo, zn, dl = z0.long(), z_new.long(), d_b.long()
    nk = nk + (_zeros((num_topics,), amt)
               .index_put_((zo,), -amt, accumulate=True)
               .index_put_((zn,), amt, accumulate=True))
    ndk = (ndk.index_put((dl, zo), -amt, accumulate=True)
           .index_put_((dl, zn), amt, accumulate=True))
    return d_rows.add_(rows), nk, ndk


def _weights(rows: torch.Tensor, nk: torch.Tensor,
             cfg: "lda.LDAConfig") -> torch.Tensor:
    """Word-proposal weights (n_wk + β)/(n_k + Vβ), in the JAX package's
    order: Vβ rounded once to float32, division by a tensor."""
    return (rows.to(torch.float32) + cfg.beta) / (
        nk.to(torch.float32)[None, :] + cfg.V * cfg.beta)


# ---------------------------------------------------------------------------
# Blocked executor (paper section 3.4).
# ---------------------------------------------------------------------------

def pipelined_sweep(state: "lda.SamplerState", key: torch.Tensor,
                    cfg: "lda.LDAConfig", block_idx: torch.Tensor,
                    block_valid: torch.Tensor, rows_per_block: int,
                    staleness: int = 0,
                    hot_words: Optional[int] = None,
                    route: Optional[ps.PushRoute] = None
                    ) -> "lda.SamplerState":
    """One staleness-bounded, double-buffered, routed blocked sweep.

    Per group of ``s + 1`` consecutive model blocks:

      1. the group's ``n_wk`` rows arrive from the previous step's
         ``PullHandle``; the next group's pull is issued at once (exact:
         a group's write-back touches only its own rows);
      2. alias tables for the group's rows only, by ``alias_build`` (on
         the card its kernel, bitwise equal to the plain construction the
         JAX package uses in training);
      3. all of the group's tokens resampled by ``mh_sample`` (training
         mode) against the group-start counts, the pulled rows as its
         table and block-local row indices;
      4. the group-boundary merge: on one process (``merges_in_one_launch``)
         one ``delta_push`` adds the group's changes into the pulled rows
         (block-local row ids), ``n_dk`` and ``n_k`` -- the executor's own
         copies -- in place; otherwise the route materialises the
         group-local delta and ``n_k``/``n_dk`` take duplicate-tolerant
         adds (``routed_merge_block``).  ``store_block_`` writes the rows back; ``z`` merges by an
         add.

    ``staleness=0`` equals ``lightlda.sweep_blocked_ref`` bitwise.
    """
    rpb = rows_per_block
    layout = state.nwk.layout
    n_blocks, cap = block_idx.shape
    assert n_blocks * rpb == layout.pad_rows, (layout.pad_rows, rpb)
    s = effective_staleness(n_blocks, staleness)
    group = s + 1
    n_groups = n_blocks // group
    grp_rows = group * rpb
    if route is None:
        route = ps.route_for(hot_words, cfg.V)

    gidx = block_idx.reshape(n_groups, group * cap)
    gval = block_valid.reshape(n_groups, group * cap)
    gcap = group * cap

    nwk = state.nwk.with_value(state.nwk.value.clone())   # owned copy
    one_launch = merges_in_one_launch(nwk)
    nk, ndk, z_flat = state.nk.value, state.ndk, state.z.clone()
    if one_launch:
        nk, ndk = nk.clone(), ndk.clone()       # owned, merged in place
    keys = jrng.split(key, n_groups)
    pulled = nwk.pull_block(0, grp_rows)
    for grp in range(n_groups):
        # 1. double buffer: await this group's rows, issue the next pull
        rows = pulled.result()
        pulled = nwk.pull_block((grp + 1) % n_groups, grp_rows)

        # 2. alias tables for the group's rows only
        table = ops.alias_build(_weights(rows, nk, cfg))

        # 3. fused resample of the group's tokens against the stale view
        idx = gidx[grp].long()
        vb = gval[grp]
        wb = state.w[idx]
        db = state.d[idx]
        z0 = z_flat[idx]
        local = torch.clamp(layout.to_physical(wb) - grp * grp_rows, 0,
                            grp_rows - 1).to(torch.int32)
        doc_draw = lda.make_doc_draw(db, z_flat, state.doc_start,
                                     state.doc_len, cfg)
        rng = lda.draw_mh_randoms(keys[grp], doc_draw, gcap, cfg)
        z_new = ops.mh_sample(rng, z0, local, db, rows.to(torch.float32),
                              ndk, nk.to(torch.float32), table.prob,
                              table.alias, cfg, frozen=False)
        z_new = torch.where(vb, z_new, z0)

        # 4. group-boundary merge; the rows go back in
        changed = (z_new != z0) & vb
        if one_launch:
            ops.delta_push(local, z0, z_new, changed, grp_rows, cfg.K,
                           out=rows, docs=db, ndk_out=ndk, nk_out=nk)
        else:
            rows, nk, ndk = routed_merge_block(route, rows, nk, ndk, local,
                                               wb, db, z0, z_new, changed,
                                               cfg.K)
        nwk.store_block_(grp, rows, grp_rows)
        z_flat.index_put_((idx,), torch.where(vb, z_new - z0, 0),
                          accumulate=True)
    return lda.SamplerState(state.w, state.d, z_flat, state.valid,
                            state.doc_start, state.doc_len, nwk,
                            state.nk.with_value(nk), ndk)


# ---------------------------------------------------------------------------
# Full-snapshot executor (paper Alg. 1).
# ---------------------------------------------------------------------------

def snapshot_sweep(state: "lda.SamplerState", key: torch.Tensor,
                   cfg: "lda.LDAConfig", staleness: int = 0,
                   hot_words: Optional[int] = None,
                   route: Optional[ps.PushRoute] = None
                   ) -> "lda.SamplerState":
    """One full-snapshot sweep with staleness-grouped token blocks.

    The word rows and alias tables come from the sweep-start snapshot
    (built once by ``alias_build``: on the card its kernel, bitwise equal to
    the plain construction the JAX package uses);
    groups of ``staleness + 1`` consecutive token blocks are resampled by
    ``mh_sample`` against the group-start ``n_k``/``n_dk``, and the group's
    deltas merge once per group into the executor's own copies of the
    tables.  On one process (``merges_in_one_launch``) that is one
    ``delta_push`` launch into ``n_wk``, ``n_dk`` and ``n_k`` together, and
    ``route`` shapes nothing here.  Otherwise the deltas are shaped by
    ``route`` and pass the backend's moments: the dense part -- the
    hybrid's ``[H, K]`` hot prefix -- is added onto the first ``H`` rows,
    the coordinate part applied by ``delta_apply_coo``, and ``n_k``/``n_dk``
    take ``token_deltas`` (``routed_merge_snapshot``).
    """
    n = state.w.shape[0]
    nblocks = n // cfg.block_tokens
    s = effective_staleness(nblocks, staleness)
    group = s + 1
    n_groups = nblocks // group
    gtok = group * cfg.block_tokens
    if route is None:
        route = ps.route_for(hot_words, cfg.V)

    handle = state.nwk
    backend = handle.client.backend
    one_launch = merges_in_one_launch(handle)

    # --- snapshot "pull" (paper section 2.3 / 3.4): an owned copy ---
    nwk_dense = handle.pull_all().result()              # [V, K] int32
    nk, ndk = state.nk.value, state.ndk
    if one_launch:
        nk, ndk = nk.clone(), ndk.clone()       # owned, merged in place

    # --- alias tables and the chain's float table from the snapshot ---
    table = ops.alias_build(_weights(nwk_dense, nk, cfg))
    nwk_table = nwk_dense.to(torch.float32)

    z_flat = state.z.clone()
    keys = jrng.split(key, n_groups)
    for grp in range(n_groups):
        lo, hi = grp * gtok, (grp + 1) * gtok
        w_b, d_b, valid_b = state.w[lo:hi], state.d[lo:hi], state.valid[lo:hi]
        z0 = z_flat[lo:hi].clone()

        doc_draw = lda.make_doc_draw(d_b, z_flat, state.doc_start,
                                     state.doc_len, cfg)
        rng = lda.draw_mh_randoms(keys[grp], doc_draw, gtok, cfg)
        z_new = ops.mh_sample(rng, z0, w_b, d_b, nwk_table, ndk,
                              nk.to(torch.float32), table.prob, table.alias,
                              cfg, frozen=False)
        z_new = torch.where(valid_b, z_new, z0)

        # --- group-boundary merge (3.3) ---
        changed = (z0 != z_new) & valid_b
        if one_launch:
            ops.delta_push(w_b, z0, z_new, changed, cfg.V, cfg.K,
                           out=nwk_dense, docs=d_b, ndk_out=ndk, nk_out=nk)
        else:
            nk, ndk = routed_merge_snapshot(route, backend, nwk_dense, nk,
                                            ndk, w_b, d_b, z0, z_new,
                                            changed, cfg.K)
        z_flat[lo:hi] = z_new

    # --- write back to the server layout ---
    new_nwk = handle.client.matrix_from_dense(
        nwk_dense, route=handle.route).localize()
    return lda.SamplerState(state.w, state.d, z_flat, state.valid,
                            state.doc_start, state.doc_len, new_nwk,
                            state.nk.with_value(nk), ndk)


# ---------------------------------------------------------------------------
# Host-side factory: what api.Session drives.
# ---------------------------------------------------------------------------

def _obs_step(step_fn, exec_cfg: ExecConfig, info: dict):
    """Wrap a sweep step with host-side sweep spans.

    Per sweep, when an obs session is installed: ``exec.dispatch`` (the
    host's enqueue window: the step returned), ``exec.sweep`` (dispatch
    plus device completion, closed by ``torch.cuda.synchronize`` on the new
    ``z``), and a ``sweep.device`` span on the ``device`` lane for the
    remainder -- how long the card ran after the host was done.  The
    *overlap* is ``1 - dispatch/total``; histograms ``exec.sweep_ms`` and
    ``exec.overlap_pct`` record both.  With no session the wrapper costs
    one lookup per sweep; the unwrapped step is ``step.raw``.  Values are
    bitwise identical with tracing on or off.
    """

    def step(st, key, *rest):
        tr = _obs.tracer_for(exec_cfg.obs)
        if tr is None:
            return step_fn(st, key, *rest)
        t0 = time.perf_counter_ns()
        out = step_fn(st, key, *rest)
        t1 = time.perf_counter_ns()
        _block(out.z)
        t2 = time.perf_counter_ns()
        overlap = 1.0 - (t1 - t0) / max(t2 - t0, 1)
        tr.complete("exec.dispatch", t0, t1, cat="exec", mode=info["mode"])
        tr.complete("exec.sweep", t0, t2, cat="exec", mode=info["mode"],
                    staleness=info["staleness"], group=info.get("group"),
                    route=info["route"],
                    overlap_pct=round(overlap * 100.0, 2))
        tr.complete("sweep.device", t1, t2, cat="device",
                    tid=tr.lane("device"))
        reg = _obs.metrics_for(exec_cfg.obs)
        if reg is not None:
            reg.histogram("exec.sweep_ms").record((t2 - t0) / 1e6)
            reg.histogram("exec.overlap_pct", unit="%").record(
                overlap * 100.0)
        return out

    step.raw = step_fn
    return step


def blocked_geometry(layout, model_blocks: int, staleness: int
                     ) -> Tuple[int, int, int]:
    """The blocked executor's (rows_per_block, n_blocks, effective
    staleness): ``pad_rows`` must split evenly, so the requested block
    count is rounded to the nearest feasible geometry."""
    rpb = -(-layout.pad_rows // model_blocks)
    while layout.pad_rows % rpb:
        rpb += 1
    n_blocks = layout.pad_rows // rpb
    return rpb, n_blocks, effective_staleness(n_blocks, staleness)


def make_stream_executor(cfg: "lda.LDAConfig", exec_cfg: ExecConfig,
                         layout, cap_round: int = 2048):
    """Build the per-shard step for the streaming trainer.

    Unlike ``make_executor`` (which builds one corpus's token index up
    front), the stream trainer sees a *sequence* of shards, all padded to
    the same token/doc geometry (``data/stream.py``).  Returns ``(step,
    build_index, info)``:

      * blocked mode (``model_blocks > 0``): ``step(state, key, idx,
        bval)``, one ``pipelined_sweep`` at staleness 0 over model blocks
        of ``rows_per_step = rows_per_block * (s + 1)`` rows (the group of
        ``s + 1`` blocks is the unit), and ``build_index(w, valid,
        cap=None) -> (idx, bval)``, the host grouping each shard's tokens
        by model block as CPU tensors (the caller moves them to the
        state's device), the capacity rounded up to ``cap_round`` (pass
        ``cap`` to pin one capacity for every shard; overflow raises);
      * snapshot mode: ``step(state, key)`` and ``build_index`` None.

    Both steps are plain functions wrapped by ``_obs_step``.
    """
    route = exec_cfg.resolve_route(cfg.V)
    if exec_cfg.model_blocks > 0:
        rpb, n_blocks, s = blocked_geometry(layout, exec_cfg.model_blocks,
                                            exec_cfg.staleness)
        rpb_step = rpb * (s + 1)

        def step_fn(st, k, idx, bval):
            return pipelined_sweep(st, k, cfg, idx, bval, rpb_step,
                                   staleness=0, route=route)

        def build_index(w, valid, cap=None):
            idx, bval = lda.block_token_index(
                np.asarray(w), np.asarray(valid), rpb_step, layout,
                cap_round=cap_round, cap=cap)
            return torch.from_numpy(idx), torch.from_numpy(bval)

        info = {"mode": "blocked", "n_blocks": n_blocks,
                "rows_per_block": rpb, "rows_per_step": rpb_step,
                "staleness": s, "group": s + 1,
                "staleness_requested": exec_cfg.staleness,
                "hot_words": exec_cfg.hot_words, "route": repr(route)}
        return _obs_step(step_fn, exec_cfg, info), build_index, info

    def step_fn(st, k):
        return snapshot_sweep(st, k, cfg, staleness=exec_cfg.staleness,
                              route=route)

    info = {"mode": "snapshot", "n_blocks": None, "rows_per_block": None,
            "staleness": exec_cfg.staleness,
            "staleness_requested": exec_cfg.staleness,
            "hot_words": exec_cfg.hot_words, "route": repr(route)}
    return _obs_step(step_fn, exec_cfg, info), None, info


def make_executor(state: "lda.SamplerState", cfg: "lda.LDAConfig",
                  exec_cfg: ExecConfig):
    """Build the one-sweep step function for an executor config.

    Returns ``(step_fn, info)``: ``step_fn(state, key) -> state`` and
    ``info`` the realised schedule (block geometry, effective staleness
    after divisor rounding, push route).  The blocked executor's token
    index is built here, on the host, at merge-unit granularity (``s + 1``
    fused blocks), as the JAX package builds it.
    """
    route = exec_cfg.resolve_route(cfg.V)
    if exec_cfg.model_blocks > 0:
        layout = state.nwk.layout
        rpb, n_blocks, s = blocked_geometry(layout, exec_cfg.model_blocks,
                                            exec_cfg.staleness)
        rpb_step = rpb * (s + 1)
        idx, bval = lda.block_token_index(state.w.cpu().numpy(),
                                          state.valid.cpu().numpy(),
                                          rpb_step, layout)
        dev = state.w.device
        idx = torch.from_numpy(idx).to(dev)
        bval = torch.from_numpy(bval).to(dev)

        def step_fn(st, k):
            return pipelined_sweep(st, k, cfg, idx, bval, rpb_step,
                                   staleness=0, route=route)

        info = {"mode": "blocked", "n_blocks": n_blocks,
                "rows_per_block": rpb, "staleness": s,
                "group": s + 1, "token_cap": int(idx.shape[1]),
                "staleness_requested": exec_cfg.staleness,
                "hot_words": exec_cfg.hot_words, "route": repr(route)}
    else:
        n_blocks = state.w.shape[0] // cfg.block_tokens
        s = effective_staleness(n_blocks, exec_cfg.staleness)

        def step_fn(st, k):
            return snapshot_sweep(st, k, cfg, staleness=exec_cfg.staleness,
                                  route=route)

        info = {"mode": "snapshot", "n_blocks": n_blocks,
                "rows_per_block": None, "staleness": s, "group": s + 1,
                "token_cap": cfg.block_tokens,
                "staleness_requested": exec_cfg.staleness,
                "hot_words": exec_cfg.hot_words, "route": repr(route)}
    return _obs_step(step_fn, exec_cfg, info), info
