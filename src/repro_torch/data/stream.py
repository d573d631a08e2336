"""Out-of-core streaming corpus pipeline (the paper's "Web-scale" axis).

The paper's headline claim is processing 135x more data than Spark LDA by
keeping *partitioned data* flowing past the parameter servers: the corpus
never lives in one memory, only the model does.  This module is the host
side of that claim -- a sharded on-disk token store plus a prefetching
loader -- so corpora far larger than host RAM stream through the PS client
shard by shard.

Layout (one directory):

  stream.json            manifest: vocab_size, shard geometry, per-shard
                         valid token/doc counts
  word_freq.npy          [V] corpus word frequencies (ids are expected to
                         be frequency-ordered already -- data/corpus.py's
                         ``reindex`` contract; an out-of-core builder does
                         that ordering as its own offline pass)
  shard_00000.w.npy      [tokens_per_shard] int32 word ids  (padded)
  shard_00000.d.npy      [tokens_per_shard] int32 *shard-local* doc ids
  shard_00000.doc_start.npy / .doc_len.npy   [doc_cap] int32 (padded)
  shard_00000.z.npy      [tokens_per_shard] int32 topic assignments --
                         created by the trainer, rewritten after every
                         visit (the paper's section-3.5 stance: ``z`` is
                         part of the *data*, counts are derived)

Every shard has identical array shapes (``tokens_per_shard`` tokens,
``doc_cap`` doc slots), so one executor step serves the whole stream with
the same shapes on every visit.  Padding tokens have ``w == d == 0`` and
are invalid (``index >= n_tokens``).

The layout is the JAX package's, byte for byte (manifest included): a
directory written by either package is read by the other.

This module is deliberately **numpy-only** (no torch import): it is a
data pipeline that runs on CPU feeder hosts, and a process that only
shards or streams a corpus must not carry an accelerator runtime in its
RSS.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

# stdlib-only telemetry (repro_torch.obs imports no torch at module
# scope), so the numpy-only constraint above holds
from repro_torch import obs as _obs

MANIFEST = "stream.json"
WORD_FREQ = "word_freq.npy"
_VERSION = 1


# ---------------------------------------------------------------------------
# Manifest / shard records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamMeta:
    """Manifest of a stream directory (everything uniform across shards)."""

    vocab_size: int
    tokens_per_shard: int   # padded token capacity of every shard
    doc_cap: int            # padded doc capacity of every shard
    num_shards: int
    num_tokens: int         # total *valid* tokens
    num_docs: int
    shard_tokens: Tuple[int, ...]   # valid tokens per shard
    shard_docs: Tuple[int, ...]     # valid docs per shard

    def to_json(self) -> dict:
        return {"version": _VERSION,
                "vocab_size": self.vocab_size,
                "tokens_per_shard": self.tokens_per_shard,
                "doc_cap": self.doc_cap,
                "num_shards": self.num_shards,
                "num_tokens": self.num_tokens,
                "num_docs": self.num_docs,
                "shard_tokens": list(self.shard_tokens),
                "shard_docs": list(self.shard_docs)}

    @classmethod
    def from_json(cls, obj: dict) -> "StreamMeta":
        if obj.get("version") != _VERSION:
            raise ValueError(f"unsupported stream manifest version "
                             f"{obj.get('version')!r}")
        return cls(vocab_size=obj["vocab_size"],
                   tokens_per_shard=obj["tokens_per_shard"],
                   doc_cap=obj["doc_cap"],
                   num_shards=obj["num_shards"],
                   num_tokens=obj["num_tokens"],
                   num_docs=obj["num_docs"],
                   shard_tokens=tuple(obj["shard_tokens"]),
                   shard_docs=tuple(obj["shard_docs"]))


@dataclasses.dataclass(frozen=True)
class StreamShard:
    """One shard's arrays (all padded to the uniform shapes).

    ``z`` is None until the trainer has initialised assignments for this
    shard.  ``valid()`` materialises the padding mask lazily (it is pure
    geometry: the first ``n_tokens`` entries are real)."""

    shard_id: int
    w: np.ndarray          # [tokens_per_shard] int32
    d: np.ndarray          # [tokens_per_shard] int32, shard-local doc ids
    doc_start: np.ndarray  # [doc_cap] int32
    doc_len: np.ndarray    # [doc_cap] int32
    n_tokens: int          # valid token count
    n_docs: int            # valid doc count
    z: Optional[np.ndarray] = None

    def valid(self) -> np.ndarray:
        return np.arange(self.w.shape[0]) < self.n_tokens

    @property
    def nbytes(self) -> int:
        n = self.w.nbytes + self.d.nbytes + self.doc_start.nbytes + \
            self.doc_len.nbytes
        if self.z is not None:
            n += self.z.nbytes
        return n


def _shard_file(path: str, sid: int, name: str) -> str:
    return os.path.join(path, f"shard_{sid:05d}.{name}.npy")


def _atomic_save(fn: str, arr: np.ndarray) -> None:
    tmp = fn + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, fn)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class ShardedCorpusWriter:
    """Shard a document stream into the on-disk layout above.

    Documents are appended in arrival order; a shard is flushed (padded to
    the uniform geometry) whenever the next document would overflow its
    token capacity or doc cap.  Memory is bounded by one shard's buffers
    regardless of corpus size -- this is what lets the benchmark *write* a
    corpus bigger than its RSS budget, not just read one.
    """

    def __init__(self, path: str, vocab_size: int, tokens_per_shard: int,
                 doc_cap: Optional[int] = None):
        if tokens_per_shard <= 0:
            raise ValueError("tokens_per_shard must be positive")
        self.path = path
        self.vocab_size = int(vocab_size)
        self.tokens_per_shard = int(tokens_per_shard)
        self.doc_cap = int(doc_cap) if doc_cap else max(
            64, tokens_per_shard // 8)
        os.makedirs(path, exist_ok=True)
        self._ws: List[np.ndarray] = []      # per-doc token arrays
        self._lens: List[int] = []
        self._ntok = 0
        self._word_freq = np.zeros(self.vocab_size, np.int64)
        self._shard_tokens: List[int] = []
        self._shard_docs: List[int] = []
        self._closed = False

    # -- appending ---------------------------------------------------------
    def add_document(self, w: Sequence[int]) -> None:
        w = np.asarray(w, np.int32)
        n = int(w.shape[0])
        if n == 0:
            return
        if n > self.tokens_per_shard:
            raise ValueError(f"document of {n} tokens exceeds "
                             f"tokens_per_shard={self.tokens_per_shard}")
        if (self._ntok + n > self.tokens_per_shard
                or len(self._lens) >= self.doc_cap):
            self._flush()
        self._ws.append(w)
        self._lens.append(n)
        self._ntok += n

    def add_tokens(self, w: np.ndarray, doc_lens: np.ndarray) -> None:
        """Bulk append: flat token array + per-document lengths.

        Vectorised doc->shard assignment (one ``searchsorted`` per flush,
        not one Python call per document) -- the path the synthetic
        benchmark generator uses at tens of millions of tokens.
        """
        w = np.asarray(w, np.int32)
        doc_lens = np.asarray(doc_lens, np.int64)
        assert int(doc_lens.sum()) == w.shape[0], "doc_lens must tile w"
        if doc_lens.size and int(doc_lens.max()) > self.tokens_per_shard:
            raise ValueError("a document exceeds tokens_per_shard")
        starts = np.concatenate([[0], np.cumsum(doc_lens)[:-1]])
        i = 0
        while i < doc_lens.shape[0]:
            cum = np.cumsum(doc_lens[i:]) + self._ntok
            fit = int(np.searchsorted(cum, self.tokens_per_shard, "right"))
            fit = min(fit, self.doc_cap - len(self._lens))
            if fit == 0:
                self._flush()
                continue
            lo = int(starts[i])
            hi = int(starts[i + fit - 1] + doc_lens[i + fit - 1])
            self._ws.append(w[lo:hi])
            self._lens.extend(int(x) for x in doc_lens[i:i + fit])
            self._ntok += hi - lo
            i += fit

    def add_corpus(self, corpus) -> None:
        """Append every document of an in-memory ``data.corpus.Corpus``
        (which is already frequency-ordered -- the ``reindex`` contract)."""
        self.add_tokens(corpus.w, corpus.doc_len.astype(np.int64))

    # -- flushing ----------------------------------------------------------
    def _flush(self) -> None:
        if not self._lens:
            return
        sid = len(self._shard_tokens)
        cap, dcap = self.tokens_per_shard, self.doc_cap
        w = np.concatenate(self._ws).astype(np.int32)
        n = int(w.shape[0])
        ndocs = len(self._lens)
        doc_len = np.zeros(dcap, np.int32)
        doc_len[:ndocs] = self._lens
        doc_start = np.zeros(dcap, np.int32)
        doc_start[1:ndocs] = np.cumsum(doc_len[:ndocs - 1])
        d = np.zeros(cap, np.int32)
        d[:n] = np.repeat(np.arange(ndocs, dtype=np.int32),
                          doc_len[:ndocs])
        wpad = np.zeros(cap, np.int32)
        wpad[:n] = w
        if (w >= self.vocab_size).any() or (w < 0).any():
            raise ValueError("word id out of range for vocab_size")
        self._word_freq += np.bincount(w, minlength=self.vocab_size)
        _atomic_save(_shard_file(self.path, sid, "w"), wpad)
        _atomic_save(_shard_file(self.path, sid, "d"), d)
        _atomic_save(_shard_file(self.path, sid, "doc_start"), doc_start)
        _atomic_save(_shard_file(self.path, sid, "doc_len"), doc_len)
        self._shard_tokens.append(n)
        self._shard_docs.append(ndocs)
        self._ws, self._lens, self._ntok = [], [], 0

    def close(self) -> StreamMeta:
        if self._closed:
            raise RuntimeError("writer already closed")
        self._flush()
        self._closed = True
        meta = StreamMeta(
            vocab_size=self.vocab_size,
            tokens_per_shard=self.tokens_per_shard,
            doc_cap=self.doc_cap,
            num_shards=len(self._shard_tokens),
            num_tokens=int(sum(self._shard_tokens)),
            num_docs=int(sum(self._shard_docs)),
            shard_tokens=tuple(self._shard_tokens),
            shard_docs=tuple(self._shard_docs))
        np.save(os.path.join(self.path, WORD_FREQ), self._word_freq)
        tmp = os.path.join(self.path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta.to_json(), f, indent=1)
        os.replace(tmp, os.path.join(self.path, MANIFEST))
        return meta

    def __enter__(self) -> "ShardedCorpusWriter":
        return self

    def __exit__(self, et, ev, tb) -> None:
        if et is None and not self._closed:
            self.close()


def write_sharded(path: str, corpus, tokens_per_shard: int,
                  doc_cap: Optional[int] = None) -> StreamMeta:
    """Shard an in-memory corpus into ``path`` (tests/launcher shortcut)."""
    w = ShardedCorpusWriter(path, corpus.vocab_size, tokens_per_shard,
                            doc_cap=doc_cap)
    w.add_corpus(corpus)
    return w.close()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class ShardedCorpusReader:
    """Open a stream directory; shard reads are memory-mapped by default."""

    def __init__(self, path: str):
        self.path = path
        manifest = os.path.join(path, MANIFEST)
        if not os.path.exists(manifest):
            raise FileNotFoundError(f"no stream manifest at {manifest}")
        with open(manifest) as f:
            self.meta = StreamMeta.from_json(json.load(f))

    @property
    def num_shards(self) -> int:
        return self.meta.num_shards

    def __len__(self) -> int:
        return self.meta.num_shards

    @property
    def word_freq(self) -> np.ndarray:
        return np.load(os.path.join(self.path, WORD_FREQ))

    def shard_nbytes(self, with_z: bool = True) -> int:
        """Bytes one loaded shard occupies (the loader's budgeting unit)."""
        per_tok = 4 * (3 if with_z else 2)          # w, d[, z] int32
        return (self.meta.tokens_per_shard * per_tok
                + self.meta.doc_cap * 8)            # doc_start + doc_len

    def shard(self, sid: int, mmap: bool = True,
              load_z: bool = True) -> StreamShard:
        mode = "r" if mmap else None
        z = None
        if load_z and self.has_z(sid):
            z = np.load(self.z_path(sid), mmap_mode=mode)
        return StreamShard(
            shard_id=sid,
            w=np.load(_shard_file(self.path, sid, "w"), mmap_mode=mode),
            d=np.load(_shard_file(self.path, sid, "d"), mmap_mode=mode),
            doc_start=np.load(_shard_file(self.path, sid, "doc_start"),
                              mmap_mode=mode),
            doc_len=np.load(_shard_file(self.path, sid, "doc_len"),
                            mmap_mode=mode),
            n_tokens=self.meta.shard_tokens[sid],
            n_docs=self.meta.shard_docs[sid],
            z=z)

    # -- topic-assignment persistence (paper section 3.5: z is data) ------
    def z_path(self, sid: int) -> str:
        return _shard_file(self.path, sid, "z")

    def has_z(self, sid: int) -> bool:
        return os.path.exists(self.z_path(sid))

    def read_z(self, sid: int) -> np.ndarray:
        return np.load(self.z_path(sid))

    def write_z(self, sid: int, z: np.ndarray) -> None:
        z = np.asarray(z, np.int32)
        assert z.shape == (self.meta.tokens_per_shard,), z.shape
        _atomic_save(self.z_path(sid), z)


def rebuild_counts_from_stream(reader: ShardedCorpusReader, num_topics: int
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Stream every shard's persisted ``z`` and histogram the counts.

    This is the paper's section-3.5 recovery (counts are derived from the
    checkpointed assignments) *and* the epoch-level conservation oracle
    the tests assert against: after any number of epochs the PS state must
    equal exactly this histogram.  Memory: O(V x K) + one shard.
    """
    meta = reader.meta
    nwk = np.zeros((meta.vocab_size, num_topics), np.int64)
    nk = np.zeros(num_topics, np.int64)
    for sid in range(meta.num_shards):
        shard = reader.shard(sid)
        if shard.z is None:
            raise FileNotFoundError(f"shard {sid} has no z file -- "
                                    "initialise the stream trainer first")
        n = shard.n_tokens
        wv = np.asarray(shard.w[:n])
        zv = np.asarray(shard.z[:n])
        np.add.at(nwk, (wv, zv), 1)
        nk += np.bincount(zv, minlength=num_topics)
    return nwk, nk


# ---------------------------------------------------------------------------
# Loader: double-buffered prefetch + per-epoch shuffled shard order
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cursor:
    """Loader position: ``pos`` indexes into epoch ``epoch``'s shard order.

    The cursor (plus the PS state and the on-disk ``z`` files) is the
    complete resumable training state -- it is what
    ``train.checkpoint.save_stream`` persists.
    """

    epoch: int = 0
    pos: int = 0

    def next(self, num_shards: int) -> "Cursor":
        if self.pos + 1 < num_shards:
            return Cursor(self.epoch, self.pos + 1)
        return Cursor(self.epoch + 1, 0)

    def to_json(self) -> dict:
        return {"epoch": self.epoch, "pos": self.pos}

    @classmethod
    def from_json(cls, obj: dict) -> "Cursor":
        return cls(epoch=int(obj["epoch"]), pos=int(obj["pos"]))


class StreamingLoader:
    """Double-buffered shard loader with per-epoch shard-order shuffling.

    The shard order of epoch ``e`` is the fixed-PRNG permutation
    ``default_rng([seed, e]).permutation(num_shards)`` -- deterministic
    given (seed, epoch), so a resumed run regenerates the identical
    schedule from the cursor alone.

    Prefetch is one shard deep (double buffer): while the consumer works
    on shard ``i``, a background thread materialises shard ``i+1`` from
    disk.  Peak loader memory is therefore ``2 * shard_nbytes``; pass
    ``memory_budget`` (bytes) to have that invariant checked up front.
    The prefetch is skipped when the next scheduled shard *is* the current
    one (possible at an epoch boundary) -- the consumer may still be
    rewriting its ``z`` file.
    """

    def __init__(self, reader: ShardedCorpusReader, seed: int = 0,
                 memory_budget: Optional[int] = None, prefetch: bool = True,
                 load_z: bool = True):
        self.reader = reader
        self.seed = int(seed)
        self.prefetch = prefetch
        self.load_z = load_z
        self.memory_budget = memory_budget
        if memory_budget is not None:
            need = 2 * reader.shard_nbytes(with_z=load_z)
            if need > memory_budget:
                raise ValueError(
                    f"double-buffered loader needs {need} bytes "
                    f"(2 shards) but memory_budget={memory_budget}; "
                    "use smaller shards or raise the budget")

    def order_for_epoch(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, int(epoch)])
        return rng.permutation(self.reader.num_shards)

    def schedule(self, start: Cursor = Cursor(), end_epoch: int = 1
                 ) -> List[Tuple[Cursor, int]]:
        """The full visit list ``[(cursor, shard_id), ...]`` from
        ``start`` to the end of epoch ``end_epoch - 1`` -- the exact
        sequence ``iterate`` walks (pure function of (seed, start))."""
        out = []
        cur = start
        while cur.epoch < end_epoch:
            order = self.order_for_epoch(cur.epoch)
            for pos in range(cur.pos, len(order)):
                out.append((Cursor(cur.epoch, pos), int(order[pos])))
            cur = Cursor(cur.epoch + 1, 0)
        return out

    _schedule = schedule

    def _load(self, sid: int) -> StreamShard:
        # materialised (mmap=False): the double buffer owns real RAM, and
        # the consumer gets plain arrays it can hand straight to a device.
        # The span lands on the loader thread's own trace track, so disk
        # reads visibly overlap the consumer's sweeps in the timeline.
        with _obs.span("stream.load", cat="stream", shard=sid):
            return self.reader.shard(sid, mmap=False, load_z=self.load_z)

    def iterate(self, start: Cursor = Cursor(), end_epoch: int = 1
                ) -> Iterator[Tuple[Cursor, int, StreamShard]]:
        """Yield ``(cursor, shard_id, shard)`` from ``start`` until the end
        of epoch ``end_epoch - 1``."""
        seq = self._schedule(start, end_epoch)
        if not seq:
            return
        if not self.prefetch:
            for cur, sid in seq:
                yield cur, sid, self._load(sid)
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._load, seq[0][1])
            for j, (cur, sid) in enumerate(seq):
                reg = _obs.metrics_registry()
                tr = _obs.tracer()
                if fut is not None:
                    # hit: the prefetched shard was ready before the
                    # consumer asked; miss: the consumer stalls on disk
                    if reg is not None:
                        reg.counter("stream.prefetch_hit" if fut.done()
                                    else "stream.prefetch_miss").inc()
                    if reg is None and tr is None:
                        shard = fut.result()
                    else:
                        t0 = _time.perf_counter_ns()
                        shard = fut.result()
                        t1 = _time.perf_counter_ns()
                        if tr is not None:
                            tr.complete("stream.shard_wait", t0, t1,
                                        cat="stream", shard=sid)
                        if reg is not None:
                            reg.histogram("stream.shard_wait_ms").record(
                                (t1 - t0) / 1e6)
                else:
                    # prefetch was skipped (next shard == current: its z
                    # file was still being rewritten) -- a forced
                    # synchronous load, always a stall
                    if reg is not None:
                        reg.counter("stream.prefetch_skip").inc()
                    shard = self._load(sid)
                fut = None
                if j + 1 < len(seq) and seq[j + 1][1] != sid:
                    fut = ex.submit(self._load, seq[j + 1][1])
                yield cur, sid, shard
