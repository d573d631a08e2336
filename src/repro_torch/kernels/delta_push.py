"""Wrappers of the hand-written CUDA kernels for count-delta aggregation,
and the host helpers of the hybrid push (paper section 3.3).

Replaces the Pallas TPU kernels ``repro/kernels/delta_push.py::
_delta_kernel`` (reached through ``delta_push_call`` and
``repro/kernels/ops.py::delta_push``) and ``::_coo_kernel`` (through
``delta_apply_coo_call`` and ``ops.delta_apply_coo``).  Both kernels live in
``csrc/delta_push.cu`` and scatter with int32 atomics into row-major int32
tables that the caller passes: they accumulate, they do not overwrite.

``delta_push`` takes up to three destinations in one launch: the ``[R, K]``
table at ``rows``, and optionally the ``[D, K]`` table at ``docs`` and the
``[K]`` vector -- on one process a training group's whole merge (n_wk, n_dk
and n_k).  Their plain versions are ``kernels.ref.delta_push_ref`` and
``kernels.ref.delta_apply_coo_ref``; the results are bitwise equal.

The hybrid split: words are frequency-ordered, so the ``H`` hottest words
are the id prefix ``w < H`` (``split_hot_cold``); their reassignments
aggregate densely through ``delta_push``, and the cold tail travels as
``(row, col, +-1)`` entries (``cold_coo``) that ``delta_apply_coo``
applies on the server side.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, stream_args

_P, _I = ctypes.c_void_p, ctypes.c_int
PUSH_KERNEL = CudaKernel("delta_push", [_P] * 8 + [_I] * 5 + [_P])
COO_KERNEL = CudaKernel("delta_apply_coo", [_P] * 4 + [_I, _I, _I, _I, _P],
                        source="delta_push")


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
             device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"delta kernels: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _require_table(out: torch.Tensor, name: str,
                   device: torch.device) -> Tuple[int, int]:
    if out.dim() != 2:
        raise ValueError(f"delta kernels: {name} must be [rows, K], got "
                         f"{tuple(out.shape)}")
    _require(out, name, torch.int32, tuple(out.shape), device)
    return out.shape[0], out.shape[1]


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def delta_push_cuda(rows: torch.Tensor, z_old: torch.Tensor,
                    z_new: torch.Tensor, changed: torch.Tensor,
                    out: torch.Tensor, docs: Optional[torch.Tensor] = None,
                    ndk_out: Optional[torch.Tensor] = None,
                    nk_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add the reassignment delta of T tokens, in one launch: for each
    token with ``changed`` (bool) set, -1 at ``z_old`` and +1 at ``z_new``
    in ``out`` [R, K] at row ``rows``, in ``ndk_out`` [D, K] at row
    ``docs`` (both or neither) and in ``nk_out`` [K] (when given).  Rows
    outside ``[0, R)`` / ``[0, D)`` and topics outside ``[0, K)`` add
    nothing there.  ``rows``/``z_old``/``z_new``/``docs`` are [T] int32.
    Returns ``out``."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"delta_push_cuda needs CUDA tensors, got {dev}")
    t = rows.shape[0]
    for name, arr in (("rows", rows), ("z_old", z_old), ("z_new", z_new)):
        _require(arr, name, torch.int32, (t,), dev)
    _require(changed, "changed", torch.bool, (t,), dev)
    r, k = _require_table(out, "out", dev)
    d = 0
    if (docs is None) != (ndk_out is None):
        raise ValueError("delta_push_cuda: docs and ndk_out go together")
    if docs is not None:
        _require(docs, "docs", torch.int32, (t,), dev)
        d, k_ndk = _require_table(ndk_out, "ndk_out", dev)
        if k_ndk != k:
            raise ValueError(f"delta_push_cuda: ndk_out has {k_ndk} "
                             f"columns, out has {k}")
    if nk_out is not None:
        _require(nk_out, "nk_out", torch.int32, (k,), dev)
    if t == 0:
        return out
    device, stream = stream_args(rows)
    PUSH_KERNEL.launch(rows.data_ptr(), z_old.data_ptr(), z_new.data_ptr(),
                       changed.data_ptr(), _ptr(docs), out.data_ptr(),
                       _ptr(ndk_out), _ptr(nk_out), t, r, d, k, device,
                       stream)
    return out


def delta_apply_coo_cuda(rows: torch.Tensor, cols: torch.Tensor,
                         vals: torch.Tensor,
                         out: torch.Tensor) -> torch.Tensor:
    """Add M COO entries into ``out`` [R, K] int32: ``vals`` at
    ``(rows, cols)``, skipping value-0 padding and entries outside
    ``[0, R) x [0, K)``.  All three inputs are [M] int32.  Returns
    ``out``."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"delta_apply_coo_cuda needs CUDA tensors, got "
                         f"{dev}")
    m = rows.shape[0]
    for name, arr in (("rows", rows), ("cols", cols), ("vals", vals)):
        _require(arr, name, torch.int32, (m,), dev)
    r, k = _require_table(out, "out", dev)
    if m == 0:
        return out
    device, stream = stream_args(rows)
    COO_KERNEL.launch(rows.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                      out.data_ptr(), m, r, k, device, stream)
    return out


# ---------------------------------------------------------------------------
# Hybrid hot/cold split (paper section 3.3): host helpers, plain tensor code.
# ---------------------------------------------------------------------------

def split_hot_cold(w: torch.Tensor, changed: torch.Tensor, hot_words: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partition changed tokens at the hot/cold word boundary: logical ids
    ``< hot_words`` are the hottest words.  Returns boolean (hot, cold)
    masks; both imply ``changed``."""
    hot = changed & (w < hot_words)
    cold = changed & (w >= hot_words)
    return hot, cold


def cold_coo(w: torch.Tensor, z_old: torch.Tensor, z_new: torch.Tensor,
             cold_mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compress reassignments into coordinate deltas: each masked token
    emits ``-1`` at ``(w, z_old)`` and ``+1`` at ``(w, z_new)``; the others
    emit value-0 entries, so the buffer has a fixed size.  Returns ``(rows
    [2B], cols [2B], vals [2B])``, all int32."""
    m = cold_mask.to(torch.int32)
    rows = torch.cat([w, w]).to(torch.int32)
    cols = torch.cat([z_old, z_new]).to(torch.int32)
    vals = torch.cat([-m, m])
    return rows, cols, vals
