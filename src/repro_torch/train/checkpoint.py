"""Checkpointing: flat-npz snapshots + the paper's LDA recovery.

The paper's fault-tolerance story (section 3.5): the parameter servers are
*not* durable -- instead the data set including topic assignments ``z`` is
checkpointed each iteration, and on failure the count tables are *rebuilt*
from ``z``.  ``save_lda`` / ``restore_lda`` implement exactly that: only
(w, d, z, valid, doc_start, doc_len) are stored; counts come back through
``lightlda.rebuild_counts``.

Files are the JAX package's: ``save`` writes the ``/``-joined keys its
``_flatten`` gives a tree (dict keys sorted, a NamedTuple field as
``.name``, a sequence index as its number, None dropped), and the stream
checkpoint has the same npz entries in the same order.  A file written by
either package restores in the other.
"""
from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.device import Device, resolve_device


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _items(tree, prefix: tuple = ()):
    """(path, leaf) pairs in the JAX package's flattening order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _items(x, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {"/".join(path): _leaf(leaf) for path, leaf in _items(tree)}


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **_flatten(tree))


def _rebuild(tree, flat: Dict[str, np.ndarray], prefix: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, prefix + (str(k),)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), flat,
                                     prefix + ("." + n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, flat, prefix + (str(i),))
                          for i, x in enumerate(tree))
    key = "/".join(prefix)
    arr = flat[key]
    assert arr.shape == tuple(tree.shape), (key, arr.shape, tree.shape)
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(arr).to(tree.device, tree.dtype)
    return arr.astype(np.asarray(tree).dtype)


def restore(path: str, like):
    """Restore into the structure of ``like`` (shape-checked; each leaf
    takes the dtype, and for a tensor the device, of ``like``'s)."""
    with np.load(path) as data:
        flat = dict(data.items())
    return _rebuild(like, flat)


# --- LDA: checkpoint assignments, rebuild counts (paper section 3.5) ---

_LDA_KEYS = ("w", "d", "z", "valid", "doc_start", "doc_len")


def save_lda(path: str, state) -> None:
    save(path, {k: getattr(state, k) for k in _LDA_KEYS})


def restore_lda(path: str, cfg, num_docs: int, device: Device = None):
    """A ``SamplerState`` on ``device`` (the card unless the caller passes
    another) from a ``save_lda`` file, its counts rebuilt from ``z``."""
    from repro_torch.core import lightlda as lda
    dev = resolve_device(device)
    with np.load(path) as data:
        w, d, z, valid, doc_start, doc_len = (
            torch.from_numpy(data[k]).to(dev) for k in _LDA_KEYS)
    nwk, nk, ndk = lda.rebuild_counts(w, d, z, valid, num_docs, cfg)
    return lda.SamplerState(w, d, z, valid, doc_start, doc_len, nwk, nk, ndk)


# --- streaming trainer: PS state + loader cursor ---
#
# The out-of-core trainer's complete state is split across two places:
# the per-shard ``z`` files live *in the stream directory* (the paper's
# "the data set including topic assignments is checkpointed", section
# 3.5), while this checkpoint holds the rest -- the PS count tables and
# the loader cursor -- plus enough config echo to refuse a mismatched
# resume.  Taken at a shard boundary (after that shard's z write-back),
# the pair is bitwise-resumable: restore + continue == never stopped.

class StreamCheckpoint(NamedTuple):
    nwk_phys: np.ndarray   # physical (cyclic) [pad_rows, K] word-topic counts
    nk: np.ndarray         # [K] topic totals
    cursor: Any            # data.stream.Cursor: next (epoch, pos) to process
    seed: int              # trainer base seed (all random streams derive here)
    meta: Dict[str, int]   # config echo, validated on resume


def save_stream(path: str, nwk_phys, nk, cursor, seed: int,
                meta: Dict[str, int]) -> None:
    """Atomically persist the stream trainer's PS state + cursor: written
    to ``path + ".tmp"``, then moved over ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, nwk_phys=_leaf(nwk_phys), nk=_leaf(nk),
                 epoch=cursor.epoch, pos=cursor.pos, seed=seed,
                 **{f"meta_{k}": v for k, v in meta.items()})
    os.replace(tmp, path)


def restore_stream(path: str) -> StreamCheckpoint:
    from repro_torch.data.stream import Cursor
    with np.load(path) as data:
        meta = {k[len("meta_"):]: int(data[k])
                for k in data.files if k.startswith("meta_")}
        return StreamCheckpoint(
            nwk_phys=data["nwk_phys"], nk=data["nk"],
            cursor=Cursor(int(data["epoch"]), int(data["pos"])),
            seed=int(data["seed"]), meta=meta)
