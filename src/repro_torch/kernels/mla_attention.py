"""Wrapper of the hand-written CUDA kernels for MLA's fused causal attention.

Replaces no TPU kernel: the JAX twin leaves attention to XLA
(``repro/models/attention.py`` reaches no ``pl.pallas_call``).  The kernels
(``csrc/mla_attention.cu``, whose note gives the design) are a
FlashAttention-2-style forward and a two-kernel backward on the tensor
cores, in bf16 or fp16, for DeepSeek-V2-Lite's head parts (dn, dr, dv) =
(128, 64, 128).  Their plain version is
``models.attention._mla_attention_plain``; ``models.attention.mla_attention``
checks the inputs and chooses between the two.

Launch counts: ``FWD_KERNEL`` (one a forward), ``DQ_KERNEL`` and
``DKDV_KERNEL`` (one each a backward), registered in ``ops.KERNELS``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaKernel, stream_args

LOG2E = 1.4426950408889634
HALF = (torch.bfloat16, torch.float16)
DIMS = (128, 64, 128)           # (dn, dr, dv) the kernels are built for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD_KERNEL = CudaKernel("mla_fwd", [_P] * 8 + [_I] * 8 + [_F, _I, _P],
                        source="mla_attention")
DQ_KERNEL = CudaKernel("mla_bwd_dq", [_P] * 11 + [_I] * 7 + [_F, _F, _I, _P],
                       source="mla_attention")
DKDV_KERNEL = CudaKernel("mla_bwd_dkdv",
                         [_P] * 11 + [_I] * 7 + [_F, _F, _I, _P],
                         source="mla_attention")


def launch_counts() -> Dict[str, int]:
    """Forward and backward launches so far (a backward is two)."""
    return {"fwd": FWD_KERNEL.launches,
            "bwd": DQ_KERNEL.launches + DKDV_KERNEL.launches}


def supported(dn: int, dr: int, dv: int) -> bool:
    """Head parts the kernels are built for."""
    return (dn, dr, dv) == DIMS


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where its data does not start on 16 bytes (the
    kernels copy rows 16 bytes at a time; a contiguous view into another
    tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shape(q_nope, q_rope, v) -> Tuple[int, ...]:
    b, t, h, dn = q_nope.shape
    if b * h > 65535:
        raise ValueError(f"mla_attention: B * H = {b * h} rows of blocks; "
                         f"the kernels take at most 65,535")
    return b, t, h, dn, q_rope.shape[-1], v.shape[-1]


def forward(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor,
            k_rope: torch.Tensor, v: torch.Tensor, scale: float,
            save: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, out32, lse)``: the output in the operands' dtype, and with
    ``save`` its float32 values and each row's log-sum-exp (log2 units,
    [B * H, T]) for the backward (else both empty).  The caller has
    checked shapes, dtype, device and contiguity
    (``models.attention.mla_attention``)."""
    b, t, h, dn, dr, dv = _shape(q_nope, q_rope, v)
    q_nope, q_rope, k_nope, k_rope, v = map(
        aligned, (q_nope, q_rope, k_nope, k_rope, v))
    out = torch.empty_like(v)
    if save:
        out32 = torch.empty(v.shape, dtype=torch.float32, device=v.device)
        lse = torch.empty((b * h, t), dtype=torch.float32, device=v.device)
    else:
        out32 = lse = torch.empty(0, dtype=torch.float32, device=v.device)
    device, stream = stream_args(v)
    FWD_KERNEL.launch(
        q_nope.data_ptr(), q_rope.data_ptr(), k_nope.data_ptr(),
        k_rope.data_ptr(), v.data_ptr(), out.data_ptr(), out32.data_ptr(),
        lse.data_ptr(), b, t, h, dn, dr, dv, int(v.dtype == torch.float16),
        int(save), scale * LOG2E, device, stream)
    return out, out32, lse


def backward(do: torch.Tensor, q_nope: torch.Tensor, q_rope: torch.Tensor,
             k_nope: torch.Tensor, k_rope: torch.Tensor, v: torch.Tensor,
             out32: torch.Tensor, lse: torch.Tensor, scale: float
             ) -> Tuple[torch.Tensor, ...]:
    """The five inputs' gradients from the output's (``do``, the
    operands' dtype): ``(dq_nope, dq_rope, dk_nope, dk_rope, dv)``."""
    b, t, h, dn, dr, dv_ = _shape(q_nope, q_rope, v)
    do, q_nope, q_rope, k_nope, k_rope, v = map(
        aligned, (do.contiguous(), q_nope, q_rope, k_nope, k_rope, v))
    delta = torch.empty((b * h, t), dtype=torch.float32, device=v.device)
    dqn, dqr = torch.empty_like(q_nope), torch.empty_like(q_rope)
    dkn, dv = torch.empty_like(k_nope), torch.empty_like(v)
    dkr32 = torch.empty((b, t, h, dr), dtype=torch.float32, device=v.device)
    device, stream = stream_args(v)
    ins = (q_nope.data_ptr(), q_rope.data_ptr(), k_nope.data_ptr(),
           k_rope.data_ptr(), v.data_ptr(), do.data_ptr())
    dims = (b, t, h, dn, dr, dv_, int(v.dtype == torch.float16))
    DQ_KERNEL.launch(*ins, out32.data_ptr(), lse.data_ptr(),
                     delta.data_ptr(), dqn.data_ptr(), dqr.data_ptr(), *dims,
                     scale * LOG2E, scale, device, stream)
    DKDV_KERNEL.launch(*ins, lse.data_ptr(), delta.data_ptr(),
                       dkn.data_ptr(), dkr32.data_ptr(), dv.data_ptr(),
                       *dims, scale * LOG2E, scale, device, stream)
    return dqn, dqr, dkn, dkr32.sum(2).to(k_rope.dtype), dv

