"""Device dispatch for the port's kernels.

Each entry point looks at the device of the tensors it is given:

  * a CUDA tensor goes to the hand-written kernel (built at first use), and
    a failed build or launch raises -- there is no fallback;
  * a CPU tensor goes to the plain PyTorch version in ``kernels.ref``.

``KERNELS`` holds each kernel's launch counter, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.alias import AliasTable
from repro_torch.kernels import alias_build as _ab
from repro_torch.kernels import delta_push as _dp
from repro_torch.kernels import mh_draws as _md
from repro_torch.kernels import mh_sample as _mh
from repro_torch.kernels import ref

KERNELS = {"mh_sample": _mh.KERNEL, "alias_build": _ab.KERNEL,
           "delta_push": _dp.PUSH_KERNEL,
           "delta_apply_coo": _dp.COO_KERNEL,
           "mh_draws_train": _md.TRAIN_KERNEL,
           "mh_draws_foldin": _md.FOLDIN_KERNEL}


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def mh_sample(rng, z0, w, d, nwk, ndk, nk, aprob, aalias, cfg,
              frozen: bool = False) -> torch.Tensor:
    """Fused MH chain over T tokens reading the tables in place (see
    ``kernels/mh_sample.py`` for the argument contract)."""
    fn = _mh.mh_sample_cuda if _route(z0, "mh_sample") else ref.mh_sample_ref
    return fn(rng, z0, w, d, nwk, ndk, nk, aprob, aalias, cfg, frozen=frozen)


def mh_draws_train(key, d_b, z_snapshot, doc_start, doc_len, batch: int,
                   cfg):
    """The MH chain's randoms for one training group of ``batch`` slots
    from one key (``[2]``, a row of the sweep's key batch): what
    ``lightlda.draw_mh_randoms(key, make_doc_draw(d_b, z_snapshot,
    doc_start, doc_len, cfg), batch, cfg)`` draws, one launch on the
    card."""
    if _route(d_b, "mh_draws_train"):
        return _md.mh_draws_train_cuda(key.contiguous(), _i32(d_b),
                                       _i32(z_snapshot), _i32(doc_start),
                                       _i32(doc_len), batch, cfg)
    return ref.mh_draws_train_ref(key, d_b, z_snapshot, doc_start, doc_len,
                                  batch, cfg)


def mh_draws_foldin(doc_keys, sweep: int, z, nd, cfg):
    """One fold-in sweep's randoms for a [B, L] batch, as four
    [mh_steps, B*L] arrays: ``_doc_randoms(fold_in(doc_keys, sweep), z,
    nd, cfg)`` in the chain's layout, one launch on the card."""
    if _route(z, "mh_draws_foldin"):
        return _md.mh_draws_foldin_cuda(doc_keys.contiguous(), sweep,
                                        _i32(z), _i32(nd), cfg)
    return ref.mh_draws_foldin_ref(doc_keys, sweep, z, nd, cfg)


def alias_build(weights: torch.Tensor) -> AliasTable:
    """Alias tables for every row of ``weights`` [V, K]."""
    if _route(weights, "alias_build"):
        return _ab.alias_build_cuda(weights.contiguous())
    return ref.alias_build_ref(weights)


def _out(out, rows: torch.Tensor, num_rows: int,
         num_topics: int) -> torch.Tensor:
    if out is None:
        return torch.zeros((num_rows, num_topics), dtype=torch.int32,
                           device=rows.device)
    if tuple(out.shape) != (num_rows, num_topics):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(num_rows, num_topics)}")
    return out


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def delta_push(rows, z_old, z_new, changed, num_rows: int, num_topics: int,
               out=None, docs=None, ndk_out=None, nk_out=None
               ) -> torch.Tensor:
    """Dense [num_rows, K] int32 reassignment delta of a token batch:
    -1 at ``(rows, z_old)`` and +1 at ``(rows, z_new)`` where ``changed``
    is non-zero and ``0 <= rows < num_rows``.  Accumulates into ``out``
    when given (the table the delta is for, where nothing else reads it),
    else into a fresh zeroed buffer; returns it.

    With ``docs`` and ``ndk_out`` [D, K] the same -1/+1 also land in
    ``ndk_out`` at row ``docs`` (rows outside ``[0, D)`` dropped), and with
    ``nk_out`` [K] in ``nk_out``: a training group's whole merge, one
    launch on the card."""
    out = _out(out, rows, num_rows, num_topics)
    if _route(rows, "delta_push"):
        if changed.dtype != torch.bool:
            changed = changed != 0
        return _dp.delta_push_cuda(
            _i32(rows), _i32(z_old), _i32(z_new), changed.contiguous(), out,
            docs=None if docs is None else _i32(docs), ndk_out=ndk_out,
            nk_out=nk_out)
    return ref.delta_push_ref(rows, z_old, z_new, changed, num_rows,
                              num_topics, out=out, docs=docs,
                              ndk_out=ndk_out, nk_out=nk_out)


def delta_apply_coo(rows, cols, vals, num_rows: int, num_topics: int,
                    out=None) -> torch.Tensor:
    """Apply a ``(row, col, val)`` COO buffer as a dense [num_rows, K]
    int32 delta (value-0 entries are padding; entries outside the matrix
    are dropped), accumulating into ``out`` when given; returns it."""
    out = _out(out, rows, num_rows, num_topics)
    if _route(rows, "delta_apply_coo"):
        return _dp.delta_apply_coo_cuda(_i32(rows), _i32(cols), _i32(vals),
                                        out)
    return ref.delta_apply_coo_ref(rows, cols, vals, num_rows, num_topics,
                                   out=out)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
