"""Device dispatch for the port's kernels.

Each entry point looks at the device of the tensors it is given:

  * a CUDA tensor goes to the hand-written kernel (built at first use), and
    a failed build or launch raises -- there is no fallback;
  * a CPU tensor goes to the plain PyTorch version in ``kernels.ref``.

``KERNELS`` holds each kernel's launch counter, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.alias import AliasTable
from repro_torch.kernels import alias_build as _ab
from repro_torch.kernels import mh_sample as _mh
from repro_torch.kernels import ref

KERNELS = {"mh_sample": _mh.KERNEL, "alias_build": _ab.KERNEL}


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def mh_sample(rng, z0, w, d, nwk, ndk, nk, aprob, aalias, cfg,
              frozen: bool = False) -> torch.Tensor:
    """Fused MH chain over T tokens reading the tables in place (see
    ``kernels/mh_sample.py`` for the argument contract)."""
    fn = _mh.mh_sample_cuda if _route(z0, "mh_sample") else ref.mh_sample_ref
    return fn(rng, z0, w, d, nwk, ndk, nk, aprob, aalias, cfg, frozen=frozen)


def alias_build(weights: torch.Tensor) -> AliasTable:
    """Alias tables for every row of ``weights`` [V, K]."""
    if _route(weights, "alias_build"):
        return _ab.alias_build_cuda(weights.contiguous())
    return ref.alias_build_ref(weights)


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
