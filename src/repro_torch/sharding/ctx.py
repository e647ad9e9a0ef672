"""The ambient mesh for activation sharding constraints: the port's
counterpart of `repro.sharding.ctx`.

`activation_mesh(mesh)` installs a mesh for the code it wraps;
`current_mesh()` reads it and `batch_axes()` names the mesh axes a batch
is split over.  The reference's `constrain(x, *spec)` becomes a
`with_sharding_constraint` under an installed mesh, so its partitioner
keeps the tensor-parallel pattern.  The port has no partitioner, and on
every mesh it runs on, one device, a constraint is the identity; the
reference's is the identity too when no mesh is installed.  The port's
models leave the calls out (`models/layers.py`, `mla.py`, `moe.py`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import rules

_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "activation_mesh", default=None)


@contextlib.contextmanager
def activation_mesh(mesh: Mesh):
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()


def constrain(x, *spec):
    """The identity: the port has no partitioner to constrain."""
    return x


def batch_axes():
    """The installed mesh's batch axes (`rules.batch_axes`)."""
    return rules.batch_axes(_MESH.get())
