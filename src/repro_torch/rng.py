"""Bit-exact port of jax's default ``threefry2x32`` PRNG, vectorised over keys.

The fold-in sampler draws all of its randomness from per-document keys, and
the port is held to the JAX package bitwise, so the port has to reproduce
jax's random stream exactly.  This module covers the calls the serving path
makes: ``PRNGKey``, ``fold_in``, ``split``, ``uniform`` (float32),
``randint`` (int32) and ``gumbel`` (float32, the LM engine's temperature
sampling), in the layout jax uses with
``jax_threefry_partitionable=True`` (the default since jax 0.5):

  * a key is a pair of uint32 words ``(k1, k2)``;
  * ``split(key, n)[i]``  = threefry(key, (0, i));
  * ``fold_in(key, x)``   = threefry(key, (0, x));
  * 32 random bits at flat position ``n`` of a sample shape are
    ``x0 ^ x1`` where ``(x0, x1) = threefry(key, (n >> 32, n & 0xFFFFFFFF))``.

A key here is an int64 tensor whose last axis has length 2 and holds the two
uint32 words; any leading axes are a batch of keys, and every function maps
over them (jax's ``vmap`` written out).  uint32 arithmetic is emulated in
int64 with ``& 0xFFFFFFFF`` after each add and shift.  This is plain tensor
code: jax draws these numbers outside its Pallas kernels too.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _as_shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher, 20 rounds, on broadcastable int64
    tensors holding uint32 values (jax ``prng._threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device: Union[str, torch.device, None] = None
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def keys_from_seeds(seeds: Sequence[int],
                    device: Union[str, torch.device, None] = None
                    ) -> torch.Tensor:
    """A [N, 2] batch of ``PRNGKey(seed)`` (one key per document)."""
    lo = torch.tensor([int(s) & MASK for s in seeds], dtype=torch.int64,
                      device=device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def _hash(keys: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry(key, (hi, lo)) with the key batch in front of the counters'
    shape: keys [*B, 2], counters [*S] -> two [*B, *S] tensors."""
    nb, ns = keys.dim() - 1, hi.dim()
    k1 = keys[..., 0].reshape(keys.shape[:-1] + (1,) * ns)
    k2 = keys[..., 1].reshape(keys.shape[:-1] + (1,) * ns)
    hi = hi.reshape((1,) * nb + tuple(hi.shape))
    lo = lo.reshape((1,) * nb + tuple(lo.shape))
    return threefry2x32(k1, k2, hi, lo)


def _counters(shape: Tuple[int, ...], device, stride: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major uint64 iota over ``shape`` as (hi, lo) uint32 halves
    (jax ``prng.iota_2x32_shape``).  ``stride`` (default ``shape[-1]``):
    the iota's rows are that long, of which ``shape[-1]`` leading columns
    are kept -- the counters of the first columns of a draw over
    ``shape[:-1] + (stride,)``."""
    if not shape:
        n = torch.zeros((), dtype=torch.int64, device=device)
    else:
        stride = shape[-1] if stride is None else stride
        rows = torch.arange(math.prod(shape[:-1]), dtype=torch.int64,
                            device=device).reshape(shape[:-1] + (1,))
        n = rows * stride + torch.arange(shape[-1], dtype=torch.int64,
                                         device=device)
    return n >> 32, n & MASK


def fold_in(keys: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in``: keys [*B, 2], scalar ``data`` -> [*B, 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    x0, x1 = _hash(keys, torch.zeros_like(data), data)
    return torch.stack([x0, x1], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys [*B, 2] -> [*B, num, 2]."""
    hi, lo = _counters((num,), keys.device)
    x0, x1 = _hash(keys, hi, lo)
    return torch.stack([x0, x1], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape,
                stride: Optional[int] = None) -> torch.Tensor:
    """32 random bits per element (uint32 values in int64): [*B, *shape].
    With ``stride``, the first ``shape[-1]`` columns of the bits over
    ``shape[:-1] + (stride,)``, computed for those columns alone."""
    hi, lo = _counters(_as_shape(shape), keys.device, stride)
    x0, x1 = _hash(keys, hi, lo)
    return x0 ^ x1


def uniform(keys: torch.Tensor, shape: Shape,
            stride: Optional[int] = None) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [0, 1): the top 23 bits become
    the mantissa of a float in [1, 2), minus 1.  (Other ranges are left out:
    XLA on the CPU fuses jax's ``x * (max - min) + min`` into one FMA, which
    a plain tensor expression does not reproduce; on [0, 1) it is exact.)
    ``stride`` as in ``random_bits``."""
    bits = random_bits(keys, shape, stride)
    one = 0x3F800000                                # float32 1.0
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def gumbel(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (its default "low" mode):
    ``-log(-log(u))`` of a uniform on [tiny, 1).  The uniform is jax's
    bitwise: ``u * (1 - tiny) + tiny`` with ``1 - tiny == 1`` in float32 is
    ``u``, or ``tiny`` where ``u == 0``, FMA or not.  The two logs are
    PyTorch's, within a few ulps of XLA's."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(uniform(keys, shape), min=tiny)
    return -torch.log(-torch.log(u))


def randint(keys: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` for int32 with Python-int bounds: two words of
    bits per value, reduced modulo the span with uint32 wraparound."""
    k = split(keys, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((higher % span) * mult) & MASK) + (lower % span)
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)
