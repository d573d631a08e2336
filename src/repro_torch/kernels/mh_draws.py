"""Wrappers of the hand-written CUDA kernels that draw jax's threefry
numbers on the LDA paths (``csrc/mh_draws.cu``).

No TPU kernel is replaced: in the JAX package XLA fuses these threefry
draws into the jitted sweep, outside Pallas.  Issued eagerly, they were
hundreds of small int64 tensor ops each; each entry point here is one
launch:

  * ``mh_draws_train_cuda`` -- ``lightlda.draw_mh_randoms(key,
    make_doc_draw(d_b, z_snapshot, doc_start, doc_len, cfg), B, cfg,
    stride)`` for one group or block, or a group's valid prefix at its
    row's counters;
  * ``mh_draws_foldin_cuda`` -- serving's ``_doc_randoms(fold_in(doc_keys,
    sweep), z, nd, cfg)`` for a [B, L] batch, in the [S, B*L] layout the
    chain reads;
  * ``threefry_keys_cuda`` -- ``rng.split`` and a chain of
    ``rng.fold_in`` over a batch of keys;
  * ``threefry_randint_cuda`` -- ``rng.randint`` over a batch of keys,
    after an optional chain of ``fold_in``.

The keys stay on the card: the kernels read them through a pointer, so a
draw costs no host synchronisation.  The plain versions are
``kernels.ref.mh_draws_train_ref``, ``mh_draws_foldin_ref``,
``threefry_keys_ref`` and ``threefry_randint_ref``; each pair is bitwise
equal.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel, stream_args

_P, _I, _F, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong, ctypes.c_uint)
TRAIN_KERNEL = CudaKernel("mh_draws_train",
                          [_P] * 9 + [_L, _L, _I, _I, _F, _U, _I, _P],
                          source="mh_draws")
FOLDIN_KERNEL = CudaKernel("mh_draws_foldin",
                           [_P] * 7 + [_I] * 5 + [_F, _U, _I, _P],
                           source="mh_draws")
KEYS_KERNEL = CudaKernel("threefry_keys", [_P, _P, _L, _P, _I, _I, _I, _P],
                         source="mh_draws")
RANDINT_KERNEL = CudaKernel("threefry_randint",
                            [_P, _P, _L, _L, _P, _I, _U, _U, _U, _I, _P],
                            source="mh_draws")
MAX_STEPS = 63          # the kernel keeps 4 keys per step in shared memory
MAX_CHAIN = 8           # fold_in data a threefry launch takes
MASK = 0xFFFFFFFF


def randint_mult(k: int) -> int:
    """``rng.randint``'s multiplier for the span ``k``: (2^16 mod k)^2
    mod k, as uint32."""
    m = (2 ** 16) % k
    return ((m * m) & 0xFFFFFFFF) % k


def randint_span(minval: int, maxval: int) -> int:
    """``rng.randint``'s span: ``maxval - minval`` modulo 2^32, or 1 where
    the range is empty."""
    return (maxval - minval) & MASK if maxval > minval else 1


def k_alpha(cfg) -> float:
    """``K * alpha`` as PyTorch adds it to a float32 tensor: the Python
    float rounded once to float32."""
    return float(np.float32(cfg.K * cfg.alpha))


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
             device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        want = "" if shape is None else f" of shape {tuple(shape)}"
        raise ValueError(
            f"mh_draws: {name} must be a contiguous {dtype} tensor{want} on "
            f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _outputs(steps: int, n: int, dev: torch.device):
    from repro_torch.core.lightlda import MHRandoms

    def f():
        return torch.empty((steps, n), dtype=torch.float32, device=dev)

    return MHRandoms(u_word=f(), u_waccept=f(),
                     z_doc=torch.empty((steps, n), dtype=torch.int32,
                                       device=dev),
                     u_daccept=f())


def _check_steps(cfg) -> None:
    if not 1 <= cfg.mh_steps <= MAX_STEPS:
        raise ValueError(f"mh_draws: mh_steps must be in [1, {MAX_STEPS}] "
                         f"(got {cfg.mh_steps})")


def mh_draws_train_cuda(key: torch.Tensor, d_b: torch.Tensor,
                        z_snapshot: torch.Tensor, doc_start: torch.Tensor,
                        doc_len: torch.Tensor, batch: int, cfg,
                        stride: Optional[int] = None):
    """Launch the training draw: ``key`` [2] int64 (a row of a key
    batch), ``d_b`` [batch] int32, ``z_snapshot`` [N], ``doc_start`` and
    ``doc_len`` [D] int32, all on one card.  ``d_b < D`` and every
    document's tokens inside ``z_snapshot`` are the caller's contract.
    ``stride`` (at least ``batch``; default ``batch``): slot ``i`` at step
    ``s`` draws at counter ``s * stride + i``.  Returns ``MHRandoms`` of
    four [mh_steps, batch] arrays."""
    dev = d_b.device
    if dev.type != "cuda":
        raise ValueError(f"mh_draws_train_cuda needs CUDA tensors, got {dev}")
    _check_steps(cfg)
    stride = batch if stride is None else int(stride)
    if stride < batch:
        raise ValueError(f"mh_draws_train: stride {stride} is shorter than "
                         f"the {batch} slots drawn")
    _require(key, "key", torch.int64, (2,), dev)
    _require(d_b, "d_b", torch.int32, (batch,), dev)
    _require(z_snapshot, "z_snapshot", torch.int32, None, dev)
    _require(doc_start, "doc_start", torch.int32, None, dev)
    _require(doc_len, "doc_len", torch.int32, doc_start.shape, dev)
    out = _outputs(cfg.mh_steps, batch, dev)
    if batch == 0:
        return out
    device, stream = stream_args(d_b)
    TRAIN_KERNEL.launch(key.data_ptr(), d_b.data_ptr(), z_snapshot.data_ptr(),
                        doc_start.data_ptr(), doc_len.data_ptr(),
                        out.u_word.data_ptr(), out.u_waccept.data_ptr(),
                        out.z_doc.data_ptr(), out.u_daccept.data_ptr(),
                        batch, stride, cfg.mh_steps, cfg.K, k_alpha(cfg),
                        randint_mult(cfg.K), device, stream)
    return out


def mh_draws_foldin_cuda(doc_keys: torch.Tensor, sweep: int,
                         z: torch.Tensor, nd: torch.Tensor, cfg):
    """Launch the fold-in draw of sweep ``sweep``: ``doc_keys`` [B, 2]
    int64, ``z`` [B, L] int32 (the sweep-start assignments), ``nd`` [B]
    int32 (valid tokens per row, at most L).  Returns ``MHRandoms`` of
    four [mh_steps, B*L] arrays."""
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"mh_draws_foldin_cuda needs CUDA tensors, got "
                         f"{dev}")
    _check_steps(cfg)
    b, l = z.shape
    _require(doc_keys, "doc_keys", torch.int64, (b, 2), dev)
    _require(z, "z", torch.int32, (b, l), dev)
    _require(nd, "nd", torch.int32, (b,), dev)
    if b > 65535:
        raise ValueError(f"mh_draws_foldin: at most 65,535 documents a "
                         f"launch (got {b})")
    out = _outputs(cfg.mh_steps, b * l, dev)
    if b * l == 0:
        return out
    device, stream = stream_args(z)
    FOLDIN_KERNEL.launch(doc_keys.data_ptr(), z.data_ptr(), nd.data_ptr(),
                         out.u_word.data_ptr(), out.u_waccept.data_ptr(),
                         out.z_doc.data_ptr(), out.u_daccept.data_ptr(),
                         b, l, cfg.mh_steps, int(sweep), cfg.K,
                         k_alpha(cfg), randint_mult(cfg.K), device, stream)
    return out


def _key_batch(keys: torch.Tensor, name: str) -> torch.device:
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2 \
            or not keys.is_contiguous():
        raise ValueError(f"{name}: keys must be a contiguous int64 tensor "
                         f"[*B, 2] on {dev}; got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    return dev


def _chain(data: Sequence[int], name: str):
    """The fold_in data as the uint32 array the launch copies, and its
    length (the array is the caller's to keep alive over the call)."""
    words = [int(x) & MASK for x in data]
    if len(words) > MAX_CHAIN:
        raise ValueError(f"{name}: at most {MAX_CHAIN} fold_in data a launch "
                         f"(got {len(words)})")
    return (ctypes.c_uint * max(len(words), 1))(*words), len(words)


def threefry_keys_cuda(keys: torch.Tensor, data: Sequence[int] = (),
                       num: int = 0) -> torch.Tensor:
    """``fold_in(...fold_in(keys, data[0])..., data[-1])`` for a [*B, 2]
    int64 key batch, then, with ``num`` > 0, ``split(., num)``: [*B, num,
    2], else [*B, 2].  One launch."""
    dev = _key_batch(keys, "threefry_keys_cuda")
    if num < 0:
        raise ValueError(f"threefry_keys: num must be >= 0 (got {num})")
    if num == 0 and not data:
        raise ValueError("threefry_keys: neither fold_in data nor a split")
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + ((num,) if num else ()) + (2,),
                      dtype=torch.int64, device=dev)
    nkeys = math.prod(lead)
    if out.numel() == 0:
        return out
    arr, n = _chain(data, "threefry_keys")
    device, stream = stream_args(keys)
    KEYS_KERNEL.launch(keys.data_ptr(), out.data_ptr(), nkeys,
                       ctypes.addressof(arr), n, int(num), device, stream)
    return out


def threefry_randint_cuda(keys: torch.Tensor, shape, minval: int,
                          maxval: int, data: Sequence[int] = ()
                          ) -> torch.Tensor:
    """``randint(fold_in(...(keys, data[0])..., data[-1]), shape, minval,
    maxval)`` for a [*B, 2] int64 key batch: int32 [*B, *shape].  One
    launch."""
    dev = _key_batch(keys, "threefry_randint_cuda")
    shape = (int(shape),) if isinstance(shape, int) else tuple(
        int(x) for x in shape)
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    span = randint_span(int(minval), int(maxval))
    arr, n = _chain(data, "threefry_randint")
    device, stream = stream_args(keys)
    RANDINT_KERNEL.launch(keys.data_ptr(), out.data_ptr(), math.prod(lead),
                          math.prod(shape), ctypes.addressof(arr), n, span,
                          randint_mult(span), int(minval) & MASK, device,
                          stream)
    return out
