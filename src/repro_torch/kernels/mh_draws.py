"""Wrappers of the hand-written CUDA kernel that draws the MH chain's
randoms (``csrc/mh_draws.cu``).

No TPU kernel is replaced: in the JAX package XLA fuses these threefry
draws into the jitted sweep, outside Pallas.  Issued eagerly, they were
about 2,100 small tensor ops per training group; each entry point here
writes a whole ``MHRandoms`` in one launch:

  * ``mh_draws_train_cuda`` -- ``lightlda.draw_mh_randoms(key,
    make_doc_draw(d_b, z_snapshot, doc_start, doc_len, cfg), B, cfg)``
    for one group or block;
  * ``mh_draws_foldin_cuda`` -- serving's ``_doc_randoms(fold_in(doc_keys,
    sweep), z, nd, cfg)`` for a [B, L] batch, in the [S, B*L] layout the
    chain reads.

The keys stay on the card: the kernels read them through a pointer, so a
group costs no host synchronisation.  The plain versions are
``kernels.ref.mh_draws_train_ref`` and ``mh_draws_foldin_ref``; the two
are bitwise equal.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels._build import CudaKernel, stream_args

_P, _I, _F, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_longlong, ctypes.c_uint)
TRAIN_KERNEL = CudaKernel("mh_draws_train",
                          [_P] * 9 + [_L, _I, _I, _F, _U, _I, _P],
                          source="mh_draws")
FOLDIN_KERNEL = CudaKernel("mh_draws_foldin",
                           [_P] * 7 + [_I] * 5 + [_F, _U, _I, _P],
                           source="mh_draws")
MAX_STEPS = 63          # the kernel keeps 4 keys per step in shared memory


def randint_mult(k: int) -> int:
    """``rng.randint``'s multiplier for the span ``k``: (2^16 mod k)^2
    mod k, as uint32."""
    m = (2 ** 16) % k
    return ((m * m) & 0xFFFFFFFF) % k


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
                        doc_len: torch.Tensor, batch: int, cfg):
    """Launch the training draw: ``key`` [2] int64 (a row of a key
    batch), ``d_b`` [batch] int32, ``z_snapshot`` [N], ``doc_start`` and
    ``doc_len`` [D] int32, all on one card.  ``d_b < D`` and every
    document's tokens inside ``z_snapshot`` are the caller's contract.
    Returns ``MHRandoms`` of four [mh_steps, batch] arrays."""
    dev = d_b.device
    if dev.type != "cuda":
        raise ValueError(f"mh_draws_train_cuda needs CUDA tensors, got {dev}")
    _check_steps(cfg)
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
                        batch, cfg.mh_steps, cfg.K, k_alpha(cfg),
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
