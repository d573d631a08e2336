"""Host memory-mapped cold tier for the tiered parameter store.

A ``ColdStore`` owns the *full* ``[num_rows, cols]`` int32 count table as
an ``np.memmap`` on disk -- the long tail of the vocabulary that does not
fit on device (the web-scale axis of the paper: vocabulary grows with the
corpus, device memory does not).  The device-resident hot tier in
``repro_torch.ps.tiered`` caches the top-H rows over this store.
Everything here is plain numpy, like ``repro_torch.data.stream``, and the
on-disk directory is the JAX package's byte for byte: each package opens
the other's stores.

On-disk layout (one directory per store)::

    <path>/coldstore.json     manifest: num_rows, cols, dtype, version
    <path>/table.int32        raw row-major [num_rows, cols] int32

The manifest is written atomically (tmp + ``os.replace``) exactly like
the stream manifest in ``data/stream.py``, so a crashed creation never
leaves a readable-but-wrong store; the data file is preallocated to full
size before the manifest appears, so ``open`` only ever sees complete
geometry.

Write discipline: the memmap is the *authority* for every non-resident
row.  Rows promoted into the hot tier go stale here and are overwritten
on eviction (the tiered store's write-back) -- the composition invariant
``hot[slot_of[r]] if resident else cold[r]`` is what the tiered tests
assert bitwise.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

MANIFEST = "coldstore.json"
DATA = "table.int32"
VERSION = 1


class ColdStore:
    """The host memmap tier: full-table int32 storage with row ops.

    All methods take/return plain numpy; out-of-range coordinate traffic
    is masked to no-ops (the same padding contract as
    ``MatrixHandle.push_coo``) so routes can hand their COO buffers over
    unfiltered.
    """

    def __init__(self, path: str, num_rows: int, cols: int,
                 mm: np.memmap):
        self.path = path
        self.num_rows = int(num_rows)
        self.cols = int(cols)
        self._mm = mm

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, path: str, num_rows: int, cols: int) -> "ColdStore":
        """Create a zeroed store (data first, manifest last, atomically)."""
        os.makedirs(path, exist_ok=True)
        fn = os.path.join(path, DATA)
        mm = np.memmap(fn, dtype=np.int32, mode="w+",
                       shape=(num_rows, cols))
        mm.flush()
        manifest = {"version": VERSION, "num_rows": int(num_rows),
                    "cols": int(cols), "dtype": "int32"}
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(path, MANIFEST))
        return cls(path, num_rows, cols, mm)

    @classmethod
    def from_dense(cls, path: str, dense) -> "ColdStore":
        """Create a store holding a copy of a dense [num_rows, cols]
        table (host or device array)."""
        arr = np.asarray(dense, dtype=np.int32)
        store = cls.create(path, arr.shape[0], arr.shape[1])
        store._mm[:] = arr
        store._mm.flush()
        return store

    @classmethod
    def open(cls, path: str, mode: str = "r+") -> "ColdStore":
        """Open an existing store via its manifest."""
        manifest = os.path.join(path, MANIFEST)
        if not os.path.exists(manifest):
            raise FileNotFoundError(f"no cold-store manifest at {manifest}")
        with open(manifest) as f:
            meta = json.load(f)
        if meta.get("version") != VERSION:
            raise ValueError(f"unsupported cold-store manifest version "
                             f"{meta.get('version')!r}")
        mm = np.memmap(os.path.join(path, DATA), dtype=np.int32, mode=mode,
                       shape=(meta["num_rows"], meta["cols"]))
        return cls(path, meta["num_rows"], meta["cols"], mm)

    # -- geometry ----------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, int]:
        return (self.num_rows, self.cols)

    @property
    def nbytes(self) -> int:
        return self.num_rows * self.cols * 4

    # -- row ops -----------------------------------------------------------
    def read_rows(self, rows, out: Optional[np.ndarray] = None
                  ) -> np.ndarray:
        """Copy of the given logical rows, [len(rows), cols] int32.  A
        *copy* deliberately: the caller is about to H2D it and the memmap
        page must stay free to be written back under it.  ``out`` (an
        int32 [len(rows), cols] array, e.g. a view of pinned host memory)
        receives the copy in place of a new array."""
        rows = np.asarray(rows, dtype=np.int64)
        if out is None:
            return np.array(self._mm[rows])
        return np.take(self._mm, rows, axis=0, out=out)

    def write_rows(self, rows, values) -> None:
        """Overwrite the given rows (the eviction write-back).  Duplicate
        row ids take the last write -- the tiered store never produces
        duplicates (slots are unique)."""
        self._mm[np.asarray(rows, dtype=np.int64)] = np.asarray(
            values, dtype=np.int32)

    def add_rows(self, rows, deltas) -> None:
        """Additive row update with duplicate accumulation (``np.add.at``:
        the host-side analogue of the device scatter-add)."""
        np.add.at(self._mm, np.asarray(rows, dtype=np.int64),
                  np.asarray(deltas, dtype=np.int32))

    def apply_coo(self, rows, cols, vals) -> None:
        """Apply compressed ``(row, col, +/-val)`` coordinate deltas --
        the cold half of a hybrid push, landing host-side.  Entries with
        out-of-range rows are padding (the route's fixed-capacity buffer)
        and masked to no-ops, matching ``MatrixHandle.push_coo``."""
        r = np.asarray(rows, dtype=np.int64)
        c = np.asarray(cols, dtype=np.int64)
        v = np.asarray(vals, dtype=np.int32)
        ok = (r >= 0) & (r < self.num_rows)
        v = np.where(ok, v, 0)
        r = np.where(ok, r, 0)
        np.add.at(self._mm, (r, c), v)

    def to_array(self) -> np.ndarray:
        """Full-table copy, [num_rows, cols] int32 (host memory!)."""
        return np.array(self._mm)

    # -- lifecycle ---------------------------------------------------------
    def flush(self) -> None:
        self._mm.flush()

    def close(self) -> None:
        self.flush()
        # release the mapping; the object must not be used afterwards
        self._mm = None

    def __repr__(self):
        return (f"ColdStore(path={self.path!r}, rows={self.num_rows}, "
                f"cols={self.cols}, {self.nbytes / 2**20:.1f} MiB)")
