"""Wrapper of the hand-written CUDA kernel for Vose alias-table builds.

Replaces the Pallas TPU kernel ``repro/kernels/alias_build.py::
_alias_kernel`` (reached through ``alias_build_call`` and
``repro/kernels/ops.py::alias_build``, whose argsort preprocessing the
kernel does itself).  The kernel (``csrc/alias_build.cu``) runs a warp per
row in shared memory: the row sum in XLA's CPU order, then one lane replays
the plain construction's retirement order without stacks.  Its plain
version is ``kernels.ref.alias_build_ref`` (``core.alias.build_alias_rows``):
the two are bitwise equal in ``prob`` and ``alias``, so training can build
its tables with the kernel and stay bitwise.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.alias import AliasTable
from repro_torch.kernels._build import CudaKernel, stream_args

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("alias_build", [_P, _P, _P, _I, _I, _I, _P])

def launch_config(k: int, device: int = 0) -> Tuple[int, int]:
    """(warps per block, rows in flight per SM) a launch at ``k`` uses, as
    the CUDA occupancy calculator gives them on ``device``: the occupancy
    ``chip_smoke.py`` reports."""
    KERNEL._load()
    fn = KERNEL._lib.alias_build_config
    fn.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = _I
    warps, rows = _I(0), _I(0)
    code = fn(k, device, ctypes.byref(warps), ctypes.byref(rows))
    if code != 0:
        raise RuntimeError(f"alias_build_config failed: CUDA error {code} "
                           f"({KERNEL._err(code).decode()})")
    return warps.value, rows.value


def alias_build_cuda(weights: torch.Tensor) -> AliasTable:
    """Alias tables for every row of ``weights`` [V, K] (float32, on CUDA,
    contiguous; unnormalised, non-negative).  A row lives in one block's
    shared memory, about 8.3 bytes an entry: past K of about 28,000 the
    launch fails and this raises."""
    if weights.device.type != "cuda":
        raise ValueError(f"alias_build_cuda needs a CUDA tensor, got "
                         f"{weights.device}")
    if weights.dim() != 2 or weights.dtype != torch.float32 \
            or not weights.is_contiguous():
        raise ValueError(f"alias_build: weights must be a contiguous float32 "
                         f"[V, K] tensor; got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    v, k = weights.shape
    prob = torch.empty_like(weights)
    alias = torch.empty((v, k), dtype=torch.int32, device=weights.device)
    if v == 0 or k == 0:
        return AliasTable(prob, alias)
    device, stream = stream_args(weights)
    KERNEL.launch(weights.data_ptr(), prob.data_ptr(), alias.data_ptr(), v, k,
                  device, stream)
    return AliasTable(prob, alias)
