"""The production mesh of the dry run.

Counterpart of src/repro/launch/mesh.py: (16, 16) over ('data', 'model'),
one pod of 256 devices, or (2, 16, 16) over ('pod', 'data', 'model').
Where the reference makes a JAX mesh of that many virtual devices, the
port's is an `AbstractMesh`: the geometry, no process behind it.  Its
collectives take fake tensors on `device` (the card unless the caller
names another).
"""

from __future__ import annotations

from repro_torch.distributed.mesh import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes, device=device)
