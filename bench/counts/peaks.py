"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates at its
700 W limit) and the floor of a piece of work against them.

The sampler's arithmetic is integer hashing and float32 compares, never a
tensor-core product, so the int32 issue rate is its compute roof:
132 SMs x 64 int32 lanes x 1,980 MHz (the boost clock) = 16.73 T ops/s.
A model's matrix products run on the tensor cores, whose dense rates
without sparsity are the data sheet's: 989 TFLOP/s in bf16 and fp16, 495 in
TF32; float32 outside the tensor cores, 67.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM, BOOST_HZ = 132, 64, 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ

BF16_FLOPS_PER_S = FP16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12


def floor_s(ops: float, nbytes: float, *,
            peak: float = INT32_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the operations
    over the compute ``peak`` (the int32 issue rate unless given) and the
    bytes over the memory bandwidth."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)
