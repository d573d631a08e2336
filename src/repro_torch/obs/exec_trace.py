"""Traced replay of the blocked executor's group schedule.

The production blocked sweep (``train.async_exec.pipelined_sweep``) enqueues
a group's launches without waiting on any of them; its phases are timed on
the device by CUDA events (``async_exec.DevicePhases``).

This module runs that same sweep with a ``SweepPhases`` that closes each of
three coarser phases on a device synchronise, so each becomes a host-timed
span:

  * ``pull.inflight``   -- the next group's ``pull_block`` window, from
                           issue to the await at the top of the next
                           iteration, drawn on a synthetic ``[pull]``
                           lane (tid >= ``LANE_BASE``);
  * ``alias.build``     -- alias tables for the group's rows (the
                           ``alias_build`` kernel on the card);
  * ``sample``          -- the group's gathers, its draws
                           (``mh_draws_train``), the Metropolis-Hastings
                           chain (``mh_sample``, training mode) and the
                           changed mask, over the group's valid slots;
  * ``merge.store``     -- the route's group-local delta (``delta_push``
                           for the dense part, ``delta_apply_coo`` for the
                           coordinate part), ``n_k``/``n_dk``, the rows'
                           write-back and ``z``, all over the group's
                           valid slots;

and a ``replay.groups`` counter.  With no obs session installed it runs
without spans or synchronises.

Numerics: the group body is ``pipelined_sweep``'s own, with the routed
merge (``async_exec.routed_merge_block``) on every backend, so the
replayed state equals the executor's (``make_executor`` with the same
``model_blocks`` and ``staleness``) bitwise in z, ``n_wk`` and ``n_k``,
whichever merge that executor takes: all of it is integer addition.  It is
a diagnostic, not a training path: the synchronises make it slower than the
executor by construction.  On a CUDA state every kernel launch is the
hand-written kernel's, and a failed launch raises; the plain versions run
only on a CPU state.

Not re-exported from ``repro_torch.obs``: that package stays stdlib-only,
and this module imports torch.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch import ps
from repro_torch.core import lightlda as lda
from repro_torch.obs import runtime as _rt
from repro_torch.obs.trace import _block
from repro_torch.train import async_exec


class _TracedPhases(async_exec.SweepPhases):
    """Spans of each group's phases into the installed obs session, each
    closed on a device synchronise; the pull's window on the pull lane.
    The executor's finer phases fold into three: ``alias.build`` is
    ``kern.alias``, ``sample`` runs from ``exec.gather`` through
    ``exec.select``, ``merge.store`` from ``kern.merge`` through
    ``exec.write_z``."""

    routed = True
    OPENS = {"kern.alias": "alias.build", "exec.gather": "sample",
             "kern.merge": "merge.store"}
    CLOSES = {"exec.gather", "kern.merge", "ps.pull"}

    def __init__(self, route_label: str, device: torch.device):
        self.tr = _rt.tracer()
        self.reg = _rt.metrics_registry()
        self.route_label = route_label
        self.probe = torch.empty(0, device=device)   # what a close waits on
        self.span = _rt.NULL_SPAN
        self.t_issue = 0

    def before_pull(self) -> None:
        self.t_issue = time.perf_counter_ns()

    def _pull_span(self, grp: int, rows: torch.Tensor, **args) -> None:
        if self.tr is not None:
            _block(rows)
            self.tr.complete("pull.inflight", self.t_issue,
                             time.perf_counter_ns(), cat="pull",
                             tid=self.tr.lane("pull"), group=grp, **args)

    def pulled(self, grp: int, rows: torch.Tensor) -> None:
        self._pull_span(grp, rows)
        if self.reg is not None:
            self.reg.counter("replay.groups").inc()

    def _close(self) -> None:
        self.span.sync_on(self.probe)
        self.span.end()
        self.span = _rt.NULL_SPAN

    def mark(self, name: str, grp: int = -1, **args) -> None:
        if name in self.CLOSES:
            self._close()
        opens = self.OPENS.get(name)
        if opens is not None and self.tr is not None:
            extra = {"route": self.route_label} if opens == "merge.store" \
                else {}
            self.span = self.tr.span(opens, cat="exec", group=grp, **extra)

    def end(self) -> None:
        self._close()

    def drained(self, pending) -> None:
        # no copy stays in flight past the sweep
        self._pull_span(0, pending.result(), drain=True)


def traced_pipelined_sweep(state: "lda.SamplerState", key: torch.Tensor,
                           cfg: "lda.LDAConfig",
                           model_blocks: int, staleness: int = 0,
                           route: Optional[ps.PushRoute] = None
                           ) -> "lda.SamplerState":
    """One blocked sweep replayed with per-phase spans.

    ``make_executor``'s blocked mode (``async_exec.blocked_index``: the
    token index at merge-unit granularity, one key a group) run through
    ``pipelined_sweep`` with ``_TracedPhases``: every group emits
    ``pull.inflight`` / ``alias.build`` / ``sample`` / ``merge.store``
    spans into the installed obs session (no session: runs silently).
    ``route`` None is the dense route, as in the JAX package's replay.
    Returns the swept state; the given one is not written into.
    """
    if route is None:
        route = ps.route_for(None, cfg.V)
    idx, bval, counts, rows = async_exec.blocked_index(state, model_blocks,
                                                       staleness)
    return async_exec.pipelined_sweep(
        state, key, cfg, idx, bval, rows, route=route, block_counts=counts,
        phases=_TracedPhases(route.label, state.z.device))
