"""Wrapper of the hand-written CUDA kernel for the LightLDA MH chain.

Replaces the Pallas TPU kernel ``repro/kernels/mh_sample.py::_mh_kernel``
(reached through ``mh_sample_call`` and ``repro/kernels/ops.py::mh_sample``).
The kernel (``csrc/mh_sample.cu``) runs one thread per token and reads the
model tables in place by row index, so the caller passes whole tables plus
per-token indices -- ``w`` into ``nwk``/``aprob``/``aalias`` and ``d`` into
``ndk`` -- instead of the TPU path's pre-gathered [T, K] rows.  For up to
four MH steps it issues every load in three dependent levels and runs the
chain as register selects; the launch sizes its blocks to T and the SM
count.  Its plain version is ``kernels.ref.mh_sample_ref``; the two are
bitwise equal.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, stream_args

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("mh_sample", [_P] * 13 + [_I, _I, _I, _F, _F, _F, _I,
                                              _I, _P])


def _require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
             device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"mh_sample: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def mh_sample_cuda(rng, z0: torch.Tensor, w: torch.Tensor, d: torch.Tensor,
                   nwk: torch.Tensor, ndk: torch.Tensor, nk: torch.Tensor,
                   aprob: torch.Tensor, aalias: torch.Tensor, cfg,
                   frozen: bool = False) -> torch.Tensor:
    """Launch the kernel: ``z0``/``w``/``d`` [T] int32, ``nwk``/``aprob``
    [R, K] float32, ``aalias`` [R, K] int32, ``ndk`` [D, K] int32, ``nk``
    [K] float32, ``rng`` four [mh_steps, T] arrays (``z_doc`` int32).
    Indices are the caller's contract: ``w < R``, ``d < D``, and every
    proposal ``< K``.  Returns the new [T] int32 assignments."""
    dev = z0.device
    if dev.type != "cuda":
        raise ValueError(f"mh_sample_cuda needs CUDA tensors, got {dev}")
    t, k, s = z0.shape[0], cfg.K, cfg.mh_steps
    _require(z0, "z0", torch.int32, (t,), dev)
    _require(w, "w", torch.int32, (t,), dev)
    _require(d, "d", torch.int32, (t,), dev)
    _require(nwk, "nwk", torch.float32, (nwk.shape[0], k), dev)
    _require(aprob, "aprob", torch.float32, (nwk.shape[0], k), dev)
    _require(aalias, "aalias", torch.int32, (nwk.shape[0], k), dev)
    _require(ndk, "ndk", torch.int32, (ndk.shape[0], k), dev)
    _require(nk, "nk", torch.float32, (k,), dev)
    for name, arr, dtype in (("u_word", rng.u_word, torch.float32),
                             ("u_waccept", rng.u_waccept, torch.float32),
                             ("z_doc", rng.z_doc, torch.int32),
                             ("u_daccept", rng.u_daccept, torch.float32)):
        _require(arr, name, dtype, (s, t), dev)
    out = torch.empty_like(z0)
    if t == 0:
        return out
    device, stream = stream_args(z0)
    KERNEL.launch(z0.data_ptr(), w.data_ptr(), d.data_ptr(), nwk.data_ptr(),
                  ndk.data_ptr(), nk.data_ptr(), aprob.data_ptr(),
                  aalias.data_ptr(), rng.u_word.data_ptr(),
                  rng.u_waccept.data_ptr(), rng.z_doc.data_ptr(),
                  rng.u_daccept.data_ptr(), out.data_ptr(), t, k, s,
                  cfg.alpha, cfg.beta, cfg.V * cfg.beta, int(frozen),
                  device, stream)
    return out
