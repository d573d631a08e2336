"""Where the port's entry points run: on the card unless the caller asks
for another device."""
from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: repro_torch runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch path")
    return dev
