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
``mh_draws_train`` kernel (the group's threefry draws), the ``mh_sample``
kernel in training mode, and the merge;
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
  * ``make_stream_executor`` -- the per-shard step of the streamed plane;
  * ``make_tiered_executor`` -- the blocked schedule over tiered storage.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import ps
from repro_torch.core import lightlda as lda
from repro_torch.kernels import ops
from repro_torch.obs import ObsConfig
from repro_torch.obs.trace import NULL_SPAN, _block


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Executor schedule knobs (orthogonal to the model's ``LDAConfig``).

    ``staleness``: how many block deltas may be in flight while a block
    samples; 0 is the synchronous schedule.  ``route``: the push policy
    (``ps.DenseRoute`` / ``ps.CooRoute`` / ``ps.HybridRoute``);
    ``hot_words`` is the scalar knob mapped through ``ps.route_for`` when
    ``route`` is None.  The string ``"auto"`` for either asks
    ``ps.autotune`` to measure candidates when the executor is built
    (``make_executor`` only).  ``model_blocks``: > 0 selects
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
                "route='auto'/staleness='auto' must be resolved by "
                "make_executor (which runs ps.autotune against the actual "
                "state) before the schedule is built; this code path "
                "(streaming / SPMD launchers) needs concrete values -- "
                "pass a ps.PushRoute / int, or run ps.autotune.autotune() "
                "yourself and use its TunedPlan.")
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


def valid_slots(counts: Sequence[int], cap: int, device
                ) -> Union[slice, torch.Tensor]:
    """The valid slots of a group's row of the token index: the first
    ``counts[j]`` of each run of ``cap`` slots.  A slice when the group is
    one block (every blocked executor's index), else an index tensor on
    ``device``."""
    if len(counts) == 1:
        return slice(0, counts[0])
    return torch.cat([torch.arange(j * cap, j * cap + n)
                      for j, n in enumerate(counts)]).to(device)


def write_valid_z(z_flat: torch.Tensor, idx: torch.Tensor,
                  z_new: torch.Tensor, cap: int, counts: Sequence[int]
                  ) -> None:
    """Write ``z_new`` into ``z_flat`` at the valid slots of ``idx`` alone:
    the first ``counts[j]`` slots of each run of ``cap`` slots.  Each valid
    slot names a token of its own, so a plain copy is exact; the padded
    slots, which all name token 0, are never touched (an accumulating put
    over them adds into that one address one slot after another)."""
    for j, n in enumerate(counts):
        if n:
            lo = j * cap
            z_flat.index_copy_(0, idx[lo:lo + n], z_new[lo:lo + n])


def _weights(rows: torch.Tensor, nk: torch.Tensor,
             cfg: "lda.LDAConfig") -> torch.Tensor:
    """Word-proposal weights (n_wk + β)/(n_k + Vβ), in the JAX package's
    order: Vβ rounded once to float32, division by a tensor."""
    return (rows.to(torch.float32) + cfg.beta) / (
        nk.to(torch.float32)[None, :] + cfg.V * cfg.beta)


# ---------------------------------------------------------------------------
# Blocked executor (paper section 3.4).
# ---------------------------------------------------------------------------

class SweepPhases:
    """What ``pipelined_sweep`` tells of each group's phases; this one
    tells nothing.  ``obs.exec_trace`` subclasses it to close every phase
    on a device synchronise.  ``routed`` True takes the routed merge on
    every backend (the same result: all of it is integer addition)."""

    routed = False

    def before_pull(self) -> None:
        """A group's pull is about to be issued."""

    def pulled(self, grp: int, rows: torch.Tensor) -> None:
        """Group ``grp``'s rows have been awaited."""

    def phase(self, name: str, grp: int, **args):
        """The span around phase ``name`` of group ``grp``."""
        return NULL_SPAN

    def drained(self, pending) -> None:
        """The sweep's wrap-around pull, which no group awaits."""


_NO_PHASES = SweepPhases()


def pipelined_sweep(state: "lda.SamplerState", key: torch.Tensor,
                    cfg: "lda.LDAConfig", block_idx: torch.Tensor,
                    block_valid: torch.Tensor, rows_per_block: int,
                    staleness: int = 0,
                    hot_words: Optional[int] = None,
                    route: Optional[ps.PushRoute] = None,
                    block_counts: Optional[Sequence[int]] = None,
                    phases: SweepPhases = _NO_PHASES
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
         group-local delta of the valid slots and ``n_k``/``n_dk`` take
         duplicate-tolerant adds (``routed_merge_block``).
         ``store_block_`` writes the rows back, and ``z`` takes the new
         topics at the valid slots alone.

    Each block's valid slots are a prefix of its row of ``block_idx``, as
    ``lightlda.block_token_index`` builds it, and each names a token of
    its own; the padding all names token 0, so the routed merge leaves it
    out (``valid_slots``) rather than add its zeros into one address one
    after another.  ``block_counts`` gives the valid slots per block from
    the host that built the index; None reads them from ``block_valid``
    (one device-to-host copy a sweep).  ``phases`` is told of each phase
    (``obs.exec_trace`` times them).  With an obs session installed, a sweep
    on the card records the z updates' device ms (CUDA events around
    them, read after the sweep's last one) in the ``exec.z_update_ms``
    histogram.  ``staleness=0`` equals ``lightlda.sweep_blocked_ref``
    bitwise.
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
    if block_counts is None:
        block_counts = block_valid.sum(1).tolist()

    nwk = state.nwk.with_value(state.nwk.value.clone())   # owned copy
    one_launch = merges_in_one_launch(nwk) and not phases.routed
    nk, ndk, z_flat = state.nk.value, state.ndk, state.z.clone()
    if one_launch:
        nk, ndk = nk.clone(), ndk.clone()       # owned, merged in place
    keys = ops.split(key, n_groups)
    # with an obs session on the card, CUDA events around each z update;
    # their device ms is recorded once the sweep is done
    reg = _obs.metrics_registry() if z_flat.is_cuda else None
    marks = []
    phases.before_pull()
    pulled = nwk.pull_block(0, grp_rows)
    for grp in range(n_groups):
        # 1. double buffer: await this group's rows, issue the next pull
        rows = pulled.result()
        phases.pulled(grp, rows)
        phases.before_pull()
        pulled = nwk.pull_block((grp + 1) % n_groups, grp_rows)

        # 2. alias tables for the group's rows only
        with phases.phase("alias.build", grp) as sp:
            table = ops.alias_build(_weights(rows, nk, cfg))
            sp.sync_on(table.prob)

        # 3. fused resample of the group's tokens against the stale view
        with phases.phase("sample", grp) as sp:
            idx = gidx[grp].long()
            vb = gval[grp]
            wb = state.w[idx]
            db = state.d[idx]
            z0 = z_flat[idx]
            local = torch.clamp(layout.to_physical(wb) - grp * grp_rows, 0,
                                grp_rows - 1).to(torch.int32)
            rng = ops.mh_draws_train(keys[grp], db, z_flat, state.doc_start,
                                     state.doc_len, gcap, cfg)
            z_new = ops.mh_sample(rng, z0, local, db, rows.to(torch.float32),
                                  ndk, nk.to(torch.float32), table.prob,
                                  table.alias, cfg, frozen=False)
            z_new = torch.where(vb, z_new, z0)
            sp.sync_on(z_new)

        # 4. group-boundary merge; the rows go back in
        counts = block_counts[grp * group:(grp + 1) * group]
        with phases.phase("merge.store", grp, route=route.label) as sp:
            changed = (z_new != z0) & vb
            if one_launch:
                ops.delta_push(local, z0, z_new, changed, grp_rows, cfg.K,
                               out=rows, docs=db, ndk_out=ndk, nk_out=nk)
            else:
                v = valid_slots(counts, cap, z0.device)
                rows, nk, ndk = routed_merge_block(
                    route, rows, nk, ndk, local[v], wb[v], db[v], z0[v],
                    z_new[v], changed[v], cfg.K)
            nwk.store_block_(grp, rows, grp_rows)
            if reg is not None:
                marks.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                marks[-1][0].record()
            write_valid_z(z_flat, idx, z_new, cap, counts)
            if reg is not None:
                marks[-1][1].record()
            sp.sync_on(z_flat)
    phases.drained(pulled)
    if marks:
        marks[-1][1].synchronize()
        reg.histogram("exec.z_update_ms").record(
            sum(a.elapsed_time(b) for a, b in marks))
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
    keys = ops.split(key, n_groups)
    for grp in range(n_groups):
        lo, hi = grp * gtok, (grp + 1) * gtok
        w_b, d_b, valid_b = state.w[lo:hi], state.d[lo:hi], state.valid[lo:hi]
        z0 = z_flat[lo:hi].clone()

        rng = ops.mh_draws_train(keys[grp], d_b, z_flat, state.doc_start,
                                 state.doc_len, gtok, cfg)
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


def blocked_index(state: "lda.SamplerState", model_blocks: int,
                  staleness: int):
    """The blocked executor's token index, built on the host at merge-unit
    granularity (``s + 1`` fused blocks a unit), as the JAX package builds
    it: ``(idx, bval, counts, rows)`` -- the index and its mask on the
    state's device, the valid slots of each unit, the rows of a unit."""
    layout = state.nwk.layout
    rpb, _, s = blocked_geometry(layout, model_blocks, staleness)
    rows = rpb * (s + 1)
    idx, bval = lda.block_token_index(state.w.cpu().numpy(),
                                      state.valid.cpu().numpy(), rows,
                                      layout)
    dev = state.w.device
    return (torch.from_numpy(idx).to(dev), torch.from_numpy(bval).to(dev),
            bval.sum(1).tolist(), rows)


def make_stream_executor(cfg: "lda.LDAConfig", exec_cfg: ExecConfig,
                         layout, cap_round: int = 2048):
    """Build the per-shard step for the streaming trainer.

    Unlike ``make_executor`` (which builds one corpus's token index up
    front), the stream trainer sees a *sequence* of shards, all padded to
    the same token/doc geometry (``data/stream.py``).  Returns ``(step,
    build_index, info)``:

      * blocked mode (``model_blocks > 0``): ``step(state, key, idx,
        bval, counts=None)``, one ``pipelined_sweep`` at staleness 0 over
        model blocks (``counts``: the valid slots per block, from the host
        copy of ``bval``)
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

        def step_fn(st, k, idx, bval, counts=None):
            return pipelined_sweep(st, k, cfg, idx, bval, rpb_step,
                                   staleness=0, route=route,
                                   block_counts=counts)

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

    ``route="auto"`` / ``staleness="auto"`` on the config run the
    ``ps.autotune`` pass against the *actual* state (word frequencies,
    batch geometry, measured apply costs and sweeps, on the state's
    device) here, before the schedule is built; the winning plan and its
    report land in ``info["autotune"]``.
    """
    report = None
    if exec_cfg.wants_autotune():
        from repro_torch.ps import autotune as _autotune
        exec_cfg, report = _autotune.resolve_exec(state, cfg, exec_cfg)
    route = exec_cfg.resolve_route(cfg.V)
    if exec_cfg.model_blocks > 0:
        rpb, n_blocks, s = blocked_geometry(state.nwk.layout,
                                            exec_cfg.model_blocks,
                                            exec_cfg.staleness)
        idx, bval, counts, rpb_step = blocked_index(
            state, exec_cfg.model_blocks, exec_cfg.staleness)

        def step_fn(st, k):
            return pipelined_sweep(st, k, cfg, idx, bval, rpb_step,
                                   staleness=0, route=route,
                                   block_counts=counts)

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
    if report is not None:
        info["autotune"] = report
    return _obs_step(step_fn, exec_cfg, info), info


# ---------------------------------------------------------------------------
# Tiered executor: blocked schedule over ps.tiered storage.
# ---------------------------------------------------------------------------

class _TierBlock(NamedTuple):
    """One model block's token index: ``idx`` [cap] int32 token ids (the
    first ``n`` valid, the rest token 0), ``bval`` [cap] bool, and
    ``touched`` (host) the block-local rows that hold a token."""

    idx: torch.Tensor
    bval: torch.Tensor
    n: int
    touched: np.ndarray


def make_tiered_executor(state: "lda.SamplerState", cfg: "lda.LDAConfig",
                         exec_cfg: ExecConfig, *, refresh_every: int = 1,
                         hot_budget_bytes: Optional[int] = None,
                         auto_resize: bool = False):
    """Build the one-sweep step for a state whose ``nwk`` is a
    ``ps.TieredMatrixHandle`` (device hot-row cache over a host memmap).

    The blocked schedule of ``pipelined_sweep`` at staleness 0 -- pull a
    model block, resample its tokens against block-start counts, write the
    owned rows back -- driven from a host loop over blocks, since the
    tier's residency maps and cold memmap are host state.  Block ``b+1``'s
    tier pull (cold-tier misses included) is issued *before* block ``b``
    samples; on the card it runs on the tier's side stream, so the miss
    path overlaps the block's kernels.  Exact, not approximate: blocks own
    disjoint rows, so the in-flight pull cannot be invalidated by the
    write-back racing it.

    Per block, the JAX package's step: ``alias_build`` on the block's
    weights, the threefry draws (``mh_draws_train``), ``mh_sample``
    (training mode), and the
    merge -- one ``delta_push`` launch adding the block's changes into its
    pulled rows, ``n_dk`` and ``n_k`` -- then ``z`` at the valid slots
    alone and the rows' changed-counts by ``index_add_``.  One
    device-to-host copy a block brings back those counts and the block's
    non-resident rows that hold a token; the host writes the changed ones
    into the memmap, the resident rows go to the hot tier on the device.

    Token index: per-block id lists padded to power-of-two capacities
    (floor 128), as the JAX package pads them -- the draws depend on the
    capacity.  After each sweep the observed per-row push traffic drives
    the tier's ``refresh()`` every ``refresh_every`` sweeps (0: never),
    and -- when ``auto_resize`` -- ``ps.autotune.retune_hot_rows`` grows
    the hot tier while the measured hit rate is below target (bounded by
    ``hot_budget_bytes``).  Returns ``(step_fn, info)`` like
    ``make_executor``.
    """
    nwk = state.nwk
    if not isinstance(nwk, ps.TieredMatrixHandle):
        raise TypeError("make_tiered_executor needs a ps.TieredMatrixHandle "
                        "state (build one via "
                        "PSClient.tiered_matrix_from_dense)")
    if exec_cfg.wants_autotune():
        raise ValueError(
            "route='auto'/staleness='auto' are not supported with tiered "
            "storage: the autotuner measures against dense in-memory "
            "handles; pass concrete values (api.job validates this).")
    if exec_cfg.model_blocks <= 0:
        raise ValueError(
            "tiered storage requires the blocked executor (the whole "
            "point is never materialising [V, K] on device): set "
            "ExecConfig.model_blocks > 0.")
    route = exec_cfg.resolve_route(cfg.V)
    rpb, n_blocks, _ = blocked_geometry(nwk.layout, exec_cfg.model_blocks, 0)
    k = cfg.K
    dev = state.w.device

    # --- host-side token index: per-block ids, power-of-two caps ---
    w_np = state.w.cpu().numpy()
    tok = np.nonzero(state.valid.cpu().numpy())[0]
    blk = w_np[tok] // rpb            # one shard: physical == logical
    order = np.argsort(blk, kind="stable")
    tok, blk = tok[order], blk[order]
    starts = np.searchsorted(blk, np.arange(n_blocks + 1))
    index = []
    for b in range(n_blocks):
        ids = tok[starts[b]: starts[b + 1]]
        if ids.size == 0:
            index.append(None)
            continue
        cap = max(128, 1 << (int(ids.size) - 1).bit_length())
        idx = np.zeros(cap, np.int32)
        idx[: ids.size] = ids
        bval = np.zeros(cap, bool)
        bval[: ids.size] = True
        index.append(_TierBlock(torch.from_numpy(idx).to(dev),
                                torch.from_numpy(bval).to(dev),
                                int(ids.size),
                                np.unique(w_np[ids]).astype(np.int64)
                                - b * rpb))
    pinned = []                       # the per-block copy's host buffer

    def fetch(rtraf: torch.Tensor, rows: torch.Tensor, local: np.ndarray):
        """``rtraf`` and the ``rows`` at block-local ``local``, on the host,
        in one device-to-host copy."""
        packed = rtraf
        if local.size:
            packed = torch.cat([rtraf, rows.index_select(
                0, torch.from_numpy(local).to(dev)).view(-1)])
        if packed.is_cuda:
            if not pinned:
                pinned.append(torch.empty(rpb * (k + 1), dtype=torch.int32,
                                          pin_memory=True))
            out = pinned[0][: packed.numel()]
            out.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            packed = out
        flat = packed.numpy()
        return flat[:rpb].copy(), flat[rpb:].reshape(-1, k)

    sweep_count = [0]

    def step(st: "lda.SamplerState", key: torch.Tensor) -> "lda.SamplerState":
        tier_h = st.nwk
        tier = tier_h.tier
        nk, ndk, z = st.nk.value.clone(), st.ndk.clone(), st.z.clone()
        keys = ops.split(key, n_blocks)
        pulled = tier_h.pull_block(0, rpb)
        for b in range(n_blocks):
            rows = pulled.result()
            if b + 1 < n_blocks:
                pulled = tier_h.pull_block(b + 1, rpb)   # issue -> overlap
            blk_b = index[b]
            if blk_b is None:
                continue
            start = b * rpb
            table = ops.alias_build(_weights(rows, nk, cfg))
            i = blk_b.idx.long()
            wb, db, z0 = st.w[i], st.d[i], z[i]
            local = torch.clamp(wb - start, 0, rpb - 1).to(torch.int32)
            rng = ops.mh_draws_train(keys[b], db, z, st.doc_start,
                                     st.doc_len, i.shape[0], cfg)
            z_new = ops.mh_sample(rng, z0, local, db, rows.to(torch.float32),
                                  ndk, nk.to(torch.float32), table.prob,
                                  table.alias, cfg, frozen=False)
            z_new = torch.where(blk_b.bval, z_new, z0)
            changed = (z_new != z0) & blk_b.bval
            ops.delta_push(local, z0, z_new, changed, rpb, k, out=rows,
                           docs=db, ndk_out=ndk, nk_out=nk)
            write_valid_z(z, i, z_new, i.shape[0], [blk_b.n])
            n = blk_b.n
            rtraf = torch.zeros(rpb, dtype=torch.int32, device=dev
                                ).index_add_(0, local[:n].long(),
                                             changed[:n].to(torch.int32))
            ids = np.arange(start, start + rpb)
            tier.store_hot(ids, rows)
            cold_local = blk_b.touched[tier.slot_of[start + blk_b.touched]
                                       < 0]
            rtraf_np, cold_vals = fetch(rtraf, rows, cold_local)
            write = rtraf_np[cold_local] > 0
            if write.any():
                tier.write_cold(start + cold_local[write], cold_vals[write])
            tier_h.note_traffic(b, rpb, rtraf_np)
        sweep_count[0] += 1
        if refresh_every > 0 and sweep_count[0] % refresh_every == 0:
            tier_h.refresh()
            if auto_resize:
                from repro_torch.ps import autotune as _autotune
                new_h = _autotune.retune_hot_rows(
                    tier.hot_rows, tier_h.tier_stats().hit_rate(),
                    vocab_size=cfg.V, budget_bytes=hot_budget_bytes,
                    num_topics=cfg.K)
                if new_h != tier.hot_rows:
                    tier_h.resize_hot(new_h)
        reg = _obs.metrics_for(exec_cfg.obs)
        if reg is not None:
            # device-resident table footprint: hot tier + the two block
            # buffers in flight (pulled + being-sampled)
            reg.gauge("exec.tiered.device_table_bytes").set(
                float(tier.device_bytes() + 2 * rpb * cfg.K * 4))
        return lda.SamplerState(st.w, st.d, z, st.valid, st.doc_start,
                                st.doc_len, tier_h, st.nk.with_value(nk),
                                ndk)

    caps = sorted({int(blk_b.idx.shape[0]) for blk_b in index
                   if blk_b is not None})
    info = {"mode": "tiered", "n_blocks": n_blocks, "rows_per_block": rpb,
            "staleness": 0, "group": 1, "token_caps": caps,
            "hot_rows": nwk.tier.hot_rows,
            "refresh_every": refresh_every, "route": repr(route)}
    return _obs_step(step, exec_cfg, info), info
