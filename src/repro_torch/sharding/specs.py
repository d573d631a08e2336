"""Mesh context for the LM scaffold.

The JAX package's ``sharding/specs.py`` also holds the PartitionSpec rules
for parameters, caches and activations on a (pod, data, model) mesh; those
are ROADMAP A.8.3.  The port runs the LM on one device, so this module
keeps ``MeshCtx`` with no mesh and ``SINGLE``, which the model and the
engine take where their twins do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """Mesh + axis roles.  ``mesh is None`` means single-device semantics,
    the only kind the port has."""

    mesh: Optional[object]
    dp: Tuple[str, ...]          # data-parallel axes
    model: Optional[str]         # tensor/expert-parallel axis

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "a device mesh for the LM is ROADMAP A.8.3, not ported yet")

    @property
    def model_size(self) -> int:
        return 1


SINGLE = MeshCtx(None, (), None)
