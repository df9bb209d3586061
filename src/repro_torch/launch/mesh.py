"""Device meshes of the FL path: one process drives every device.

JAX's ``shard_map`` is single-controller: one process launches work on
every device of the mesh.  The port keeps that model.  A ``Mesh`` is a
tuple of ``torch.device``s with named axis sizes; a shard is a slab of a
tensor placed on its device; a cross-device sum is a sum of per-slab
scalars on the mesh's first device, and a gather a ``torch.cat`` onto it.
Nothing here uses ``torch.distributed``.

``make_host_mesh`` (the P-sharded merge) and ``make_clients_mesh`` (the
cohort-sharded executor) clamp to the devices that exist, as the JAX
package's do: ``torch.cuda.device_count()`` cards, or one CPU.  A size-1
mesh is no mesh (fl/executor.py and the ``*_sharded`` kernels take the
unsharded path).  The ``Mesh`` constructor itself accepts a device list
with repeats, such as ``(cpu, cpu)`` or ``(cuda:0, cuda:0)``: the
counterpart of ``--xla_force_host_platform_device_count``, which runs
the sharded code on one device.

``make_production_mesh`` gives the reference's production layout, (16, 16)
over ("data", "model") or (2, 16, 16) over ("pod", "data", "model"), as an
``AbstractMesh``: axis names and sizes with no devices, the counterpart of
``jax.sharding.AbstractMesh``.  The sharding rules (sharding/rules.py)
read only a mesh's ``.shape`` and ``.size``, so the dry run
(launch/dryrun.py) works out per-device shapes for 256 or 512 cards that
nobody holds.

The large-model train step is multi-controller instead: one process a
rank, as ``torchrun`` starts them, each placing its shards with DTensor
(sharding/rules.py ``to_named``).  ``to_device_mesh`` turns a ``Mesh`` or
``AbstractMesh`` into the ``DeviceMesh`` over the process group's ranks
with the same axis names and shape, and refuses a group of another size,
as ``jax.make_mesh`` refuses too few devices; ``abstract_mesh`` is the way
back, for the rules, which read axis sizes by name.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device
from ..sharding.rules import CLIENT_AXIS, MESH_AXES


class Mesh:
    """Devices laid out along named axes (row-major over ``axes``)."""

    def __init__(self, devices: Sequence[DeviceLike],
                 axes: Sequence[Tuple[str, int]]):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        self.shape: Dict[str, int] = {name: int(size) for name, size in axes}
        unknown = [a for a in self.shape if a not in MESH_AXES]
        if unknown:
            raise ValueError(f"undeclared mesh axes {unknown}; declared: "
                             f"{MESH_AXES}")
        if not self.devices or math.prod(self.shape.values()) != len(
                self.devices):
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"mesh of shape {self.shape}")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def key(self) -> tuple:
        """Hashable identity: axis sizes and devices."""
        return tuple(self.shape.items()), self.devices

    def __repr__(self) -> str:
        return f"Mesh({list(map(str, self.devices))}, {self.shape})"


class AbstractMesh:
    """Named axis sizes with no devices (row-major over ``axes``)."""

    def __init__(self, axes: Sequence[Tuple[str, int]]):
        self.shape: Dict[str, int] = {name: int(size) for name, size in axes}
        unknown = [a for a in self.shape if a not in MESH_AXES]
        if unknown:
            raise ValueError(f"undeclared mesh axes {unknown}; declared: "
                             f"{MESH_AXES}")

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(tuple(zip(axes, shape)))


def _devices(n: int, device: DeviceLike) -> Tuple[torch.device, ...]:
    """The first ``n`` devices of ``device``'s type."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,)
    return tuple(torch.device("cuda", i) for i in range(n))


def _available(device: DeviceLike) -> int:
    return (torch.cuda.device_count()
            if resolve_device(device).type == "cuda" else 1)


def make_host_mesh(model: int = 1, data: int = 1,
                   device: DeviceLike = None) -> Mesh:
    """A ("data", "model") mesh over the devices of ``device``'s type
    (``None`` means the cards), clamped to how many exist."""
    n = _available(device)
    model = min(model, n)
    data = max(1, min(data, n // model))
    return Mesh(_devices(data * model, device),
                (("data", data), ("model", model)))


def make_clients_mesh(clients: int = 1, device: DeviceLike = None) -> Mesh:
    """The 1-axis ("clients",) mesh the executor shards its cohort over,
    clamped to the devices that exist: asking for 8 on one card gives a
    size-1 mesh, which the executor treats as no mesh."""
    n = max(1, min(int(clients), _available(device)))
    return Mesh(_devices(n, device), ((CLIENT_AXIS, n),))


def to_device_mesh(mesh, device: DeviceLike = None) -> DeviceMesh:
    """``mesh``'s axes (names and sizes, row-major) as a ``DeviceMesh`` of
    ``device``'s type (``None`` means the cards) over the ranks of the
    default process group.  Raises ``ValueError`` when the group's size (1
    in a process that joined none) is not the mesh's."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mesh.size:
        raise ValueError(f"a mesh of shape {mesh.shape} needs {mesh.size} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(resolve_device(device).type,
                            tuple(mesh.shape.values()),
                            mesh_dim_names=tuple(mesh.shape))


def abstract_mesh(device_mesh: DeviceMesh) -> AbstractMesh:
    """The axis names and sizes of ``device_mesh``."""
    return AbstractMesh(tuple(zip(device_mesh.mesh_dim_names,
                                  device_mesh.shape)))
