"""Shard-visit lease bookkeeping for the elastic worker pool.

The stream schedule (``StreamingLoader.schedule``) is a list of visits
``(epoch, pos, shard_id)``; the network parameter server hands them to
workers as exclusive, re-assignable *leases* (DESIGN.md section 15).
This module is the pure state machine -- numpy/stdlib only, no sockets --
so the policy is unit-testable and the straggler benchmark can drive it
in simulation.

Invariants:

  * **Shard exclusivity**: a shard with an active lease is locked, and a
    shard's visits are granted in schedule (epoch) order -- so the z file
    a worker reads is always the state its epoch expects, and two workers
    can never hold the same shard (which would double-apply deltas).
  * **Exactly-once completion**: a visit moves pending -> active ->
    done; ``release``/``release_worker`` (worker death, straggler
    re-queue) moves it back to pending, so every visit is *completed*
    exactly once even if it was *attempted* several times.

Assignment modes:

  * ``dynamic``       one global queue; free workers pull the next
                      available visit (stragglers naturally take fewer);
  * ``static``        visits pre-partitioned round-robin over worker
                      slots; a worker only sees its own slot (the
                      no-re-assignment baseline);
  * ``static_steal``  static, but an idle worker steals the next
                      unstarted visit from the most-loaded slot -- the
                      slowest worker's unstarted shards are re-queued
                      onto whoever is free.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

PENDING, ACTIVE, DONE = 0, 1, 2
MODES = ("dynamic", "static", "static_steal")


class Lease(NamedTuple):
    """One granted shard visit."""
    lease_id: int
    epoch: int
    pos: int
    shard_id: int


class ShardLeaseBook:
    """Exclusive, re-assignable leases over a stream visit schedule."""

    def __init__(self, schedule: List[Tuple[int, int, int]], *,
                 mode: str = "dynamic", slots: int = 0):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES} (got {mode!r})")
        if mode != "dynamic" and slots < 1:
            raise ValueError(f"{mode} assignment needs slots >= 1")
        self.mode = mode
        self.slots = int(slots)
        # one record per visit, in schedule order; lease_id == index
        self._visits = [{
            "epoch": int(e), "pos": int(p), "shard": int(s),
            "state": PENDING, "worker": None,
            "slot": (i % slots if mode != "dynamic" else None),
        } for i, (e, p, s) in enumerate(schedule)]
        self.stolen = 0
        self.reassigned = 0             # release_worker re-queues

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._visits)

    @property
    def done(self) -> int:
        return sum(v["state"] == DONE for v in self._visits)

    @property
    def active(self) -> int:
        return sum(v["state"] == ACTIVE for v in self._visits)

    def all_done(self) -> bool:
        return all(v["state"] == DONE for v in self._visits)

    def visit(self, lease_id: int) -> dict:
        """The visit record behind a lease id (read-only by convention)."""
        return self._visits[lease_id]

    def slot_backlog(self) -> Dict[int, int]:
        """Pending visit count per static slot (None key for orphans)."""
        out: Dict[int, int] = {}
        for v in self._visits:
            if v["state"] == PENDING:
                out[v["slot"]] = out.get(v["slot"], 0) + 1
        return out

    # -- the state machine ---------------------------------------------------
    def _heads(self):
        """Grantable visits: for each shard, its earliest not-done visit,
        provided that visit is pending (an active one locks the shard)."""
        seen = set()
        for i, v in enumerate(self._visits):
            if v["state"] == DONE or v["shard"] in seen:
                continue
            seen.add(v["shard"])
            if v["state"] == PENDING:
                yield i, v

    def acquire(self, worker: int, slot: Optional[int] = None
                ) -> Tuple[str, Optional[Lease]]:
        """Try to grant the next visit to ``worker`` (static modes route
        by ``slot``).  Returns ``("lease", Lease)``, ``("wait", None)``
        (retry later) or ``("done", None)`` (schedule drained)."""
        if self.all_done():
            return "done", None
        heads = list(self._heads())
        pick = None
        if self.mode == "dynamic":
            pick = heads[0] if heads else None
        else:
            mine = [h for h in heads if h[1]["slot"] in (slot, None)]
            if mine:
                pick = mine[0]
            elif self.mode == "static_steal" and heads:
                # steal from the most backlogged slot (the straggler)
                backlog = self.slot_backlog()
                victim = max(backlog, key=lambda s: backlog[s])
                stealable = [h for h in heads if h[1]["slot"] == victim]
                if stealable:
                    pick = stealable[-1]    # its *last* unstarted visit
                    pick[1]["slot"] = slot
                    self.stolen += 1
        if pick is None:
            return "wait", None
        i, v = pick
        v["state"], v["worker"] = ACTIVE, worker
        return "lease", Lease(i, v["epoch"], v["pos"], v["shard"])

    def complete(self, lease_id: int) -> bool:
        """Mark a granted visit done.  False if it was not active (e.g.
        already re-queued after an eviction and completed by another
        worker -- the caller should treat its work as superseded)."""
        v = self._visits[lease_id]
        if v["state"] != ACTIVE:
            return False
        v["state"], v["worker"] = DONE, None
        return True

    def release(self, lease_id: int) -> None:
        """Re-queue one granted visit (worker gave it up)."""
        v = self._visits[lease_id]
        if v["state"] == ACTIVE:
            v["state"], v["worker"] = PENDING, None
            self.reassigned += 1

    def release_worker(self, worker: int) -> int:
        """Re-queue everything a (dead) worker held; its statically
        assigned pending visits become orphans any worker may take.
        Returns the number of active leases re-queued."""
        n = 0
        for v in self._visits:
            if v["state"] == ACTIVE and v["worker"] == worker:
                v["state"], v["worker"] = PENDING, None
                n += 1
        self.reassigned += n
        return n

    def orphan_slot(self, slot: int) -> int:
        """Static modes: mark a dead worker's unstarted visits takeable
        by anyone (slot None), so pure ``static`` cannot deadlock."""
        n = 0
        for v in self._visits:
            if v["state"] == PENDING and v["slot"] == slot:
                v["slot"] = None
                n += 1
        return n

    def stats(self) -> dict:
        return {"total": len(self._visits), "done": self.done,
                "active": self.active, "stolen": self.stolen,
                "reassigned": self.reassigned, "mode": self.mode}
