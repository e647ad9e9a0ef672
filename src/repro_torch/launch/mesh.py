"""Device meshes: the port's counterpart of `repro.launch.mesh`.

The reference builds `jax.make_mesh` meshes: the production one over TPU
v5e pods (16 x 16 chips, optionally 2 pods), a small one for CI, and a
host one over the local devices.  The port has no virtual devices, so a
`Mesh` here is its own small record: ordered axis names, each axis's
size, and the torch devices it spans, or None for an abstract mesh that
the sharding rules and the dry run reason about but nothing runs on.
A `torch.distributed` `DeviceMesh` is not used: it needs a process group
for each device, and a 256-device mesh does not exist on one host.

The mesh constructors are functions, not module constants, so
importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named-axis device mesh.  `shape` maps each axis to its size, in
    `axis_names` order (the rules read `mesh.shape[a]` as the reference
    reads a jax mesh's); `devices` is None for an abstract mesh."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"a {self.name} mesh needs {self.size} devices, "
                             f"got {len(self.devices)}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """'16x16', '2x16x16', ...: the reference's report names."""
        return "x".join(str(s) for s in self.sizes)


def _axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, (16, 16) over ("data", "model"),
    or (2, 16, 16) with a leading "pod" axis, as an abstract mesh (the
    reference's dry run had only virtual devices for it too)."""
    return Mesh(_axes(multi_pod), (2, 16, 16) if multi_pod else (16, 16))


def make_test_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's CI mesh, (2, 4) or (2, 2, 2), abstract."""
    return Mesh(_axes(multi_pod), (2, 2, 2) if multi_pod else (2, 4))


def make_host_mesh(device: Union[str, torch.device, None] = None) -> Mesh:
    """A (1, 1) ("data", "model") mesh over the one device
    `resolve_device(device)` gives: CUDA unless the caller asks for the
    CPU.  The reference spreads (1, n) over every local device; the port
    runs one process on one card."""
    from repro_torch.core.coexec import resolve_device
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))
