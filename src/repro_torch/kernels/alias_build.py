"""Wrapper of the hand-written CUDA kernel for Vose alias-table builds.

Replaces the Pallas TPU kernel ``repro/kernels/alias_build.py::
_alias_kernel`` (reached through ``alias_build_call`` and
``repro/kernels/ops.py::alias_build``, whose argsort preprocessing the
kernel does itself).  The kernel (``csrc/alias_build.cu``) runs one thread
per row over a [V, K] int32 stack scratch that this wrapper allocates.  Its
plain version is ``kernels.ref.alias_build_ref``: the induced pmfs agree to
float rounding; the alias assignments may differ.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.alias import AliasTable
from repro_torch.kernels._build import CudaKernel, stream_args

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("alias_build", [_P, _P, _P, _P, _I, _I, _I, _P])


def alias_build_cuda(weights: torch.Tensor) -> AliasTable:
    """Alias tables for every row of ``weights`` [V, K] (float32, on CUDA,
    contiguous; unnormalised, non-negative)."""
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
    stack = torch.empty((v, k), dtype=torch.int32, device=weights.device)
    device, stream = stream_args(weights)
    KERNEL.launch(weights.data_ptr(), prob.data_ptr(), alias.data_ptr(),
                  stack.data_ptr(), v, k, device, stream)
    return AliasTable(prob, alias)
