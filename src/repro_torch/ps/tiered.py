"""Tiered parameter storage: device hot-row cache over a host cold tier.

The paper's web-scale claim ("135x more data and 10x more topics") needs
the model to outgrow device memory: LightLDA keeps only the hot slice of
the count table near the sampler and streams the long tail.  This module
is that storage layer for the PS client API:

  * the **hot tier** is a device-resident ``[H, K]`` int32 tensor holding
    the ``H`` currently-hottest rows under an explicit logical->physical
    row map (``slot_of`` / ``ids``): logical row ``r`` lives in hot slot
    ``slot_of[r]`` when resident, and slot ``s`` holds logical row
    ``ids[s]``;
  * the **cold tier** is a host ``np.memmap`` holding the full ``[V, K]``
    table (``repro_torch.ps.coldstore.ColdStore``).

Ownership contract (what makes composition exact): a *resident* row's
authoritative value is its hot-tier slot -- its memmap copy is stale and
is only rewritten at eviction (the device-to-host write-back).  A
non-resident row lives solely in the memmap.  The composed table is::

    compose(r) = hot[slot_of[r]]  if slot_of[r] >= 0 else  cold[r]

and because every update on either tier is an exact int32 copy or add,
``compose`` equals the single-tier table bitwise after any schedule of
pulls, pushes, promotions and evictions.

Pushes split on residency: the resident half lands on the hot tier in slot
space through the ``delta_push`` kernel (reassignments) or
``delta_apply_coo`` (coordinate deltas), the cold half as numpy adds into
the memmap.

Miss path: a pull on the card runs on a side stream.  It first waits for
the work already queued on the caller's stream (so it sees every write
issued before it), reads the cold rows from the memmap into one of two
pinned host buffers, copies them to the card (``non_blocking``) and
composes them there with the hot rows it gathers.  ``PullHandle.result()``
makes the caller's stream wait on the pull's event, so a pull issued
before a block samples overlaps it.  A pinned buffer is refilled only once
its previous copy's event has completed.  On the CPU a pull is computed at
once.

Refresh policy: pushes bump a per-row traffic counter; ``refresh()``
promotes the top-H rows by observed traffic and evicts the rest (stable
ordering, lowest id wins ties), then halves the counters so the window
tracks the recent workload.  ``ps/autotune.py`` sizes H from frequency mass
and re-sizes it from the measured hit rate.  ``refresh`` and ``resize``
run between sweeps, with no pull in flight.

The obs plane sees ``ps.tier.hit_rate`` / ``ps.tier.evictions`` /
``ps.tier.hot_rows`` / ``ps.tier.device_bytes`` gauges and
``tier.miss_fetch`` / ``tier.refresh`` spans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core.pserver import CyclicLayout, DistributedMatrix
from repro_torch.device import Device, resolve_device
from repro_torch.kernels import ops
from repro_torch.ps.client import PSClient, PullHandle, ReadOnlyView
from repro_torch.ps.coldstore import ColdStore
from repro_torch.ps.routes import DenseRoute, PushRoute, Reassign, RouteDelta


def host(x) -> np.ndarray:
    """A numpy array from a tensor (copied to the host) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class TieredBackend:
    """Backend moments for the tiered store (conforms to ``ps.Backend``).

    One process owns both tiers, so all four moments are identities --
    the tiering happens *below* the backend protocol, in how the handle
    services pulls and pushes.
    """

    axis_name = None
    model_axis = None

    def pull_full(self, storage: DistributedMatrix) -> DistributedMatrix:
        return storage

    def reduce(self, delta: torch.Tensor) -> torch.Tensor:
        return delta

    def gather_concat(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def localize(self, full: DistributedMatrix) -> DistributedMatrix:
        return full


@dataclasses.dataclass
class TierStats:
    """Running tier telemetry.

    ``hits``/``misses`` count *push-traffic entries* (changed topic
    reassignments) landing on resident vs cold rows -- the traffic-mass
    hit rate the refresh policy optimises.  ``pull_hits``/``pull_misses``
    count pulled rows by residency; ``h2d_bytes`` the rows read up from
    the cold tier (misses and promotions), ``d2h_bytes`` the rows written
    back to it (evictions, flushes and changed cold rows).
    """

    hits: int = 0
    misses: int = 0
    pull_hits: int = 0
    pull_misses: int = 0
    promotions: int = 0
    evictions: int = 0
    refreshes: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return (self.hits / total) if total else 1.0

    def to_json(self) -> dict:
        return dict(dataclasses.asdict(self), hit_rate=self.hit_rate())


class TieredMatrix:
    """The two-tier count table (mutable host object).

    Holds the hot device tensor, the cold memmap store, the row maps and
    the traffic counters.  Tiered training runs the host-driven blocked
    executor (``train.async_exec.make_tiered_executor``).
    """

    def __init__(self, cold: ColdStore, hot_rows: int,
                 resident: Optional[np.ndarray] = None, *,
                 device: Device = None):
        self.cold = cold
        self.num_rows = cold.num_rows
        self.cols = cold.cols
        self.device = resolve_device(device)
        # THE clamp (mirrors HybridRoute.clamped): every consumer sees
        # the same effective H in [0, num_rows]
        self.hot_rows = min(max(int(hot_rows), 0), self.num_rows)
        self.traffic = np.zeros(self.num_rows, np.int64)
        self.stats = TierStats()
        self._side = None                  # the pulls' stream, on the card
        self._pinned = [None, None]        # two host buffers for misses
        self._pinned_done = [None, None]   # their copies' events
        self._turn = 0
        self._init_residency(resident)

    def _init_residency(self, resident: Optional[np.ndarray]) -> None:
        h, k = self.hot_rows, self.cols
        self.slot_of = np.full(self.num_rows, -1, np.int64)
        self.ids = np.full(h, -1, np.int64)
        if h == 0:
            self.hot = torch.zeros((0, k), dtype=torch.int32,
                                   device=self.device)
            return
        if resident is None:
            # frequency-ordered ids (the section-3.2 contract) make the
            # id prefix the right initial guess; refresh adapts it
            resident = np.arange(h, dtype=np.int64)
        rows = np.unique(np.asarray(resident, np.int64))[:h]
        self.ids[: rows.size] = rows
        self.slot_of[rows] = np.arange(rows.size)
        vals = self.cold.read_rows(rows)
        if rows.size < h:
            vals = np.pad(vals, ((0, h - rows.size), (0, 0)))
        self.hot = torch.from_numpy(vals).to(self.device)   # promotion H2D
        self.stats.h2d_bytes += int(vals.nbytes)
        self.stats.promotions += int(rows.size)

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- geometry ----------------------------------------------------------
    @property
    def shape(self):
        return (self.num_rows, self.cols)

    def device_bytes(self) -> int:
        """Bytes of count table resident on device (the hot tier)."""
        return int(self.hot.numel()) * 4

    # -- composition (pull side) -------------------------------------------
    def _pinned_rows(self, n: int):
        """``(i, buffer)``: pinned host buffer ``i`` of at least ``n`` rows,
        once its previous copy has completed; the two buffers alternate."""
        i, self._turn = self._turn, self._turn ^ 1
        if self._pinned_done[i] is not None:
            self._pinned_done[i].synchronize()
            self._pinned_done[i] = None
        buf = self._pinned[i]
        if buf is None or buf.shape[0] < n:
            buf = torch.empty((n, self.cols), dtype=torch.int32,
                              pin_memory=True)
            self._pinned[i] = buf
        return i, buf

    def pull_rows(self, rows: np.ndarray) -> PullHandle:
        """Issue the composed value of the given logical rows, [B, K] on
        the device, as a future.

        Resident rows gather from the hot tier; cold rows read from the
        memmap (the miss path, traced as ``tier.miss_fetch``).  The compose
        is exact copies, never arithmetic.
        """
        rows = np.asarray(rows, np.int64)
        slots = self.slot_of[rows]
        res = slots >= 0
        n_cold = int(rows.size - res.sum())
        self.stats.pull_hits += int(res.sum())
        self.stats.pull_misses += n_cold
        if self.device.type != "cuda":
            return PullHandle(self._compose(rows, slots, res, n_cold, None))
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            out = self._compose(rows, slots, res, n_cold, self._side)
            self.hot.record_stream(self._side)
            done = torch.cuda.Event()
            done.record(self._side)
        out.record_stream(torch.cuda.current_stream(self.device))
        return PullHandle(out, done)

    def _compose(self, rows, slots, res, n_cold, stream) -> torch.Tensor:
        if n_cold == 0:
            return self.hot.index_select(0, self._dev(slots))
        sp = _obs.span("tier.miss_fetch", cat="ps", rows=n_cold,
                       h2d_bytes=n_cold * self.cols * 4)
        cold_rows = rows[~res]
        if stream is None:
            cold_dev = self._dev(self.cold.read_rows(cold_rows))
        else:
            i, buf = self._pinned_rows(n_cold)
            self.cold.read_rows(cold_rows, out=buf[:n_cold].numpy())
            cold_dev = torch.empty((n_cold, self.cols), dtype=torch.int32,
                                   device=self.device)
            cold_dev.copy_(buf[:n_cold], non_blocking=True)   # H2D
            self._pinned_done[i] = torch.cuda.Event()
            self._pinned_done[i].record(stream)
        sp.end()
        self.stats.h2d_bytes += n_cold * self.cols * 4
        if n_cold == rows.size:
            return cold_dev
        out = torch.empty((rows.size, self.cols), dtype=torch.int32,
                          device=self.device)
        out.index_copy_(0, self._dev(np.nonzero(res)[0]),
                        self.hot.index_select(0, self._dev(slots[res])))
        return out.index_copy_(0, self._dev(np.nonzero(~res)[0]), cold_dev)

    def compose_rows(self, rows: np.ndarray) -> torch.Tensor:
        """The composed value of the given logical rows, [B, K] on device
        (``pull_rows`` awaited)."""
        return self.pull_rows(rows).result()

    def to_dense(self) -> torch.Tensor:
        """The full composed [V, K] table (materialises host-side first;
        this is the snapshot/freeze path, not the training hot path)."""
        base = self.cold.to_array()
        mask = self.ids >= 0
        if mask.any():
            base[self.ids[mask]] = self._hot_values(np.nonzero(mask)[0])
        return torch.from_numpy(base).to(self.device)

    # -- writes (push side) ------------------------------------------------
    def note_traffic(self, rows: np.ndarray, counts: np.ndarray) -> None:
        """Account per-row push traffic (changed-reassignment counts):
        feeds both the refresh policy and the hit/miss stats."""
        rows = np.asarray(rows, np.int64)
        counts = np.asarray(counts, np.int64)
        np.add.at(self.traffic, rows, counts)
        res = self.slot_of[rows] >= 0
        self.stats.hits += int(counts[res].sum())
        self.stats.misses += int(counts[~res].sum())

    def store_hot(self, rows: np.ndarray, values: torch.Tensor) -> np.ndarray:
        """Overwrite the resident ones of logical ``rows`` with their
        ``values`` (device [B, K]) in the hot tier; returns the host mask
        of the rows that are not resident."""
        rows = np.asarray(rows, np.int64)
        slots = self.slot_of[rows]
        res = slots >= 0
        if res.all():
            self.hot.index_copy_(0, self._dev(slots), values)
        elif res.any():
            self.hot.index_copy_(0, self._dev(slots[res]), values.index_select(
                0, self._dev(np.nonzero(res)[0])))
        return ~res

    def write_cold(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Write host ``values`` of non-resident logical ``rows`` back into
        the memmap."""
        self.cold.write_rows(rows, values)
        self.stats.d2h_bytes += int(np.asarray(values).nbytes)

    def store_rows(self, rows: np.ndarray, values: torch.Tensor,
                   changed: Optional[np.ndarray] = None) -> None:
        """Overwrite logical ``rows`` with ``values`` (device [B, K]) -- the
        exclusive-owner write-back (``store_block`` semantics).

        Resident rows land in the hot tier on device; cold rows are copied
        to the host into the memmap.  ``changed`` (host bool [B]) limits the
        cold write-back to rows that changed -- unchanged rows carry a zero
        delta, so skipping them is bitwise free.
        """
        rows = np.asarray(rows, np.int64)
        cold = self.store_hot(rows, values)
        if changed is not None:
            cold = cold & np.asarray(changed, bool)
        if cold.any():
            vals = values.index_select(
                0, self._dev(np.nonzero(cold)[0])).cpu().numpy()   # D2H
            self.write_cold(rows[cold], vals)

    def push_reassign(self, re: Reassign) -> None:
        """Apply a reassignment batch split on *residency*: resident
        entries add into the hot tier in slot space (one ``delta_push``);
        cold entries apply host-side as COO triples into the memmap."""
        w = host(re.words).astype(np.int64)
        changed = host(re.changed).astype(bool)
        z_old = host(re.z_old)
        z_new = host(re.z_new)
        self.note_traffic(w[changed], np.ones(int(changed.sum()), np.int64))
        slots = self.slot_of[np.clip(w, 0, self.num_rows - 1)]
        res = (slots >= 0) & (w < self.num_rows)
        hot_m = res & changed
        if hot_m.any():
            ops.delta_push(self._dev(np.where(res, slots, 0)),
                           self._dev(z_old), self._dev(z_new),
                           self._dev(hot_m), self.hot_rows, self.cols,
                           out=self.hot)
        cold_m = (~res) & changed & (w < self.num_rows)
        if cold_m.any():
            r = w[cold_m]
            self.cold.apply_coo(np.concatenate([r, r]),
                                np.concatenate([z_old[cold_m],
                                                z_new[cold_m]]),
                                np.concatenate([-np.ones(r.size, np.int32),
                                                np.ones(r.size, np.int32)]))

    def push_coo(self, rows, cols, vals) -> None:
        """Coordinate deltas split on residency (resident -> one
        ``delta_apply_coo`` in slot space, cold -> host ``np.add.at``);
        out-of-range rows are value-0 no-ops (the client's padding
        contract)."""
        r = host(rows).astype(np.int64)
        c = host(cols).astype(np.int64)
        v = host(vals).astype(np.int32)
        ok = (r >= 0) & (r < self.num_rows)
        slots = self.slot_of[np.where(ok, r, 0)]
        res = ok & (slots >= 0)
        if res.any():
            ops.delta_apply_coo(self._dev(np.where(res, slots, 0)),
                                self._dev(c), self._dev(np.where(res, v, 0)),
                                self.hot_rows, self.cols, out=self.hot)
        cold = ok & ~res
        if cold.any():
            self.cold.apply_coo(r[cold], c[cold], v[cold])

    # -- residency management ----------------------------------------------
    def _hot_values(self, slots: np.ndarray) -> np.ndarray:
        return self.hot.index_select(0, self._dev(slots)).cpu().numpy()

    def refresh(self, decay: bool = True) -> dict:
        """Promote/evict so the hot tier holds the top-H rows by observed
        push traffic.  Deterministic: stable sort, lowest id wins ties.
        Evictions write the authoritative hot value back to the memmap
        before the slot is reused; promotions read the memmap value up.
        Both are exact copies -- composition is unchanged.
        """
        h = self.hot_rows
        sp = _obs.span("tier.refresh", cat="ps")
        n_evict = n_promote = 0
        if 0 < h < self.num_rows:
            target = np.argsort(-self.traffic, kind="stable")[:h]
            in_target = np.zeros(self.num_rows, bool)
            in_target[target] = True
            resident = self.ids[self.ids >= 0]
            evict = resident[~in_target[resident]]
            if evict.size:
                slots_e = self.slot_of[evict]
                vals = self._hot_values(slots_e)              # D2H
                self.cold.write_rows(evict, vals)
                self.slot_of[evict] = -1
                self.ids[slots_e] = -1
                self.stats.d2h_bytes += int(vals.nbytes)
                n_evict = int(evict.size)
            promote = target[self.slot_of[target] < 0]
            free = np.nonzero(self.ids < 0)[0]
            promote = promote[: free.size]
            if promote.size:
                vals = self.cold.read_rows(promote)
                self.hot.index_copy_(0, self._dev(free[: promote.size]),
                                     self._dev(vals))         # H2D
                self.ids[free[: promote.size]] = promote
                self.slot_of[promote] = free[: promote.size]
                self.stats.h2d_bytes += int(vals.nbytes)
                n_promote = int(promote.size)
        self.stats.evictions += n_evict
        self.stats.promotions += n_promote
        self.stats.refreshes += 1
        if decay:
            self.traffic //= 2    # recent pushes dominate the next window
        self.publish_gauges()
        if sp is not _obs.NULL_SPAN:
            sp.set(evicted=n_evict, promoted=n_promote,
                   hit_rate=round(self.stats.hit_rate(), 4))
            sp.end()
        return {"evicted": n_evict, "promoted": n_promote}

    def resize(self, hot_rows: int) -> None:
        """Re-size the hot tier (the autotuner's hit-rate-driven knob):
        write every resident row back, reallocate, promote the top rows
        by traffic into the new capacity."""
        resident = self.ids[self.ids >= 0]
        if resident.size:
            vals = self._hot_values(self.slot_of[resident])
            self.cold.write_rows(resident, vals)
            self.stats.d2h_bytes += int(vals.nbytes)
            self.stats.evictions += int(resident.size)
        self.hot_rows = min(max(int(hot_rows), 0), self.num_rows)
        target = np.argsort(-self.traffic, kind="stable")[: self.hot_rows]
        self._init_residency(np.sort(target))
        self.publish_gauges()

    # -- obs ---------------------------------------------------------------
    def publish_gauges(self) -> None:
        reg = _obs.metrics_registry()
        if reg is None:
            return
        reg.gauge("ps.tier.hit_rate").set(self.stats.hit_rate())
        reg.gauge("ps.tier.evictions").set(float(self.stats.evictions))
        reg.gauge("ps.tier.hot_rows").set(float(self.hot_rows))
        reg.gauge("ps.tier.device_bytes").set(float(self.device_bytes()))

    # -- lifecycle ---------------------------------------------------------
    def flush(self) -> None:
        """Write every resident row's authoritative value back to the
        memmap (without evicting) and flush it -- after this the cold
        tier alone equals the composed table on disk."""
        resident = self.ids[self.ids >= 0]
        if resident.size:
            vals = self._hot_values(self.slot_of[resident])
            self.cold.write_rows(resident, vals)
            self.stats.d2h_bytes += int(vals.nbytes)
        self.cold.flush()

    def __repr__(self):
        return (f"TieredMatrix(V={self.num_rows}, K={self.cols}, "
                f"H={self.hot_rows}, hit_rate="
                f"{self.stats.hit_rate():.3f})")


class TieredMatrixHandle:
    """Client handle over a ``TieredMatrix``, mirroring ``MatrixHandle``.

    Duck-typed to the ``MatrixHandle`` read/write surface (``pull`` /
    ``pull_block`` / ``pull_all`` / ``push`` / ``push_coo`` /
    ``store_block`` / ``to_dense`` / ``read_view``) so everything built on
    handles -- ``SnapshotPublisher.publish_view``, the session result,
    perplexity eval -- composes the two tiers without knowing they exist.
    Mutating calls update the underlying tier *and return the handle*, so
    both the functional idiom (``h = h.push(re)``) and the mutable one
    work.
    """

    def __init__(self, tier: TieredMatrix, client, route: PushRoute):
        self.tier = tier
        self.client = client
        self.route = route

    # -- storage mirror ----------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self.tier.num_rows

    @property
    def cols(self) -> int:
        return self.tier.cols

    @property
    def num_shards(self) -> int:
        return 1

    @property
    def layout(self) -> CyclicLayout:
        # one logical shard: physical == logical, so block b covers the
        # contiguous id range [b*rpb, (b+1)*rpb)
        return CyclicLayout(self.tier.num_rows, 1)

    def with_route(self, route: PushRoute) -> "TieredMatrixHandle":
        self.route = route
        return self

    def tier_stats(self) -> TierStats:
        return self.tier.stats

    # -- pulls -------------------------------------------------------------
    def _block_ids(self, block, rows_per_block: int) -> np.ndarray:
        start = int(block) * int(rows_per_block)
        return np.arange(start, min(start + int(rows_per_block),
                                    self.tier.num_rows))

    def pull(self, rows) -> PullHandle:
        return self.tier.pull_rows(host(rows))

    def pull_block(self, block, rows_per_block: int) -> PullHandle:
        return self.tier.pull_rows(self._block_ids(block, rows_per_block))

    def pull_all(self) -> PullHandle:
        return PullHandle(self.tier.to_dense())

    def to_dense(self) -> torch.Tensor:
        return self.tier.to_dense()

    def num_blocks(self, rows_per_block: int) -> int:
        return -(-self.layout.pad_rows // int(rows_per_block))

    def block_logical_rows(self, block, rows_per_block: int):
        return self.layout.block_rows(block, rows_per_block)

    # -- pushes ------------------------------------------------------------
    def push(self, re: Reassign, *,
             hot_prefix: Optional[int] = None) -> "TieredMatrixHandle":
        """Push a reassignment batch, split on tier residency (the tier
        boundary supersedes the route's hot/cold id boundary -- residency
        IS the hot set here).  Traced as a ``ps.push`` span labelled
        ``tiered`` with the route's traffic dict, like every push."""
        sp = _obs.span("ps.push", cat="ps")
        if sp is not _obs.NULL_SPAN:
            batch = int(re.rows.shape[0])
            sp.set(route="tiered", batch=batch,
                   **self.route.traffic(batch, self.num_rows, self.cols,
                                        hot_prefix=hot_prefix))
        self.tier.push_reassign(re)
        if sp is not _obs.NULL_SPAN:
            sp.sync_on(self.tier.hot)
            ms = sp.end()
            reg = _obs.metrics_registry()
            if reg is not None:
                reg.histogram("ps.push_ms.tiered").record(ms)
                reg.counter("ps.push_count.tiered").inc()
        return self

    def push_plan(self, plan: RouteDelta) -> "TieredMatrixHandle":
        """Apply an already-planned ``RouteDelta``: the prefix-dense part
        lands on the leading logical rows, the COO part splits on
        residency (same contract as ``MatrixHandle.push_plan``)."""
        if plan.dense is not None:
            h = int(plan.dense.shape[0])
            rows = np.arange(min(h, self.num_rows))
            cur = self.tier.compose_rows(rows)
            self.tier.store_rows(rows, cur + plan.dense[: rows.size])
        if plan.coo is not None:
            self.push_coo(*plan.coo)
        return self

    def push_coo(self, rows, cols, vals) -> "TieredMatrixHandle":
        self.tier.push_coo(rows, cols, vals)
        return self

    def store_block(self, block, rows: torch.Tensor, rows_per_block: int,
                    row_changed: Optional[np.ndarray] = None
                    ) -> "TieredMatrixHandle":
        """Write back an exclusively-owned block (the executor's merge).
        ``row_changed`` (host bool) skips the cold-tier write-back for rows
        the block left untouched -- bitwise free, since their delta is 0."""
        ids = self._block_ids(block, rows_per_block)
        self.tier.store_rows(
            ids, rows[: ids.size],
            None if row_changed is None else row_changed[: ids.size])
        return self

    def note_traffic(self, block, rows_per_block: int,
                     row_traffic: np.ndarray) -> None:
        """Feed one block's per-row changed-counts into the refresh
        policy's traffic window (and the hit/miss accounting)."""
        ids = self._block_ids(block, rows_per_block)
        self.tier.note_traffic(ids, np.asarray(row_traffic)[: ids.size])

    # -- residency / lifecycle --------------------------------------------
    def refresh(self, decay: bool = True) -> "TieredMatrixHandle":
        self.tier.refresh(decay=decay)
        return self

    def resize_hot(self, hot_rows: int) -> "TieredMatrixHandle":
        self.tier.resize(hot_rows)
        return self

    def localize(self) -> "TieredMatrixHandle":
        return self

    def read_view(self) -> ReadOnlyView:
        return ReadOnlyView(self)

    def flush(self) -> None:
        self.tier.flush()

    def __repr__(self):
        return f"TieredMatrixHandle({self.tier!r}, route={self.route!r})"


def tiered_matrix_from_dense(dense, hot_rows: int, path: str, *,
                             route: Optional[PushRoute] = None,
                             client=None,
                             resident: Optional[np.ndarray] = None,
                             device: Device = None) -> TieredMatrixHandle:
    """Build a tiered handle holding ``dense`` ([V, K] counts, a tensor or
    an array): the full table lands in a new ``ColdStore`` at ``path`` and
    the top rows are promoted into a fresh hot tier on ``device`` (the card
    unless the caller passes another).  The sanctioned construction point
    (also reachable as ``PSClient.tiered_matrix_from_dense``)."""
    cold = ColdStore.from_dense(path, host(dense))
    tier = TieredMatrix(cold, hot_rows, resident=resident, device=device)
    tier.publish_gauges()
    if client is None:
        client = PSClient(backend=TieredBackend())
    return TieredMatrixHandle(tier, client, route or DenseRoute())
