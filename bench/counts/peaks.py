"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates) and the
floor of a piece of work against them.

The sampler's arithmetic is integer hashing and float32 compares, never a
tensor-core product, so the int32 issue rate is its compute roof:
132 SMs x 64 int32 lanes x 1,980 MHz (the boost clock) = 16.73 T ops/s.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, INT32_LANES_PER_SM, BOOST_HZ = 132, 64, 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ


def floor_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the int32 peak and the bytes over the memory bandwidth."""
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
