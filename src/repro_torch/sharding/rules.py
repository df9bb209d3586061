"""Mesh-axis vocabulary and the slicing rules of the sharded FL paths.

The port's copy of what the FL path needs from the JAX package's
sharding/rules.py: the declared axis names, ``merge_axes`` (the flat
server merge splits its P dim over every axis of its mesh) and, standing
in for ``cohort_spec()`` and ``merge_spec()``, ``shard_slices``: one
contiguous equal slice of a dim per mesh device, in device order, for the
vectorized executor's padded cohort dim K and the merge's padded P dim.
The model-sharding rules of that module (FSDP/TP specs) are not ported.
"""
from __future__ import annotations

from typing import List, Tuple

# the declared mesh-axis names:
#   pod / data / model : the JAX package's production mesh; data / model
#                        also name the host mesh of the P-sharded merge
#                        (make_host_mesh)
#   clients            : the cohort (K) axis of the vectorized executor
#                        (make_clients_mesh, fl/executor.py)
CLIENT_AXIS = "clients"
MESH_AXES: Tuple[str, ...] = ("pod", "data", "model", CLIENT_AXIS)


def merge_axes(mesh) -> Tuple[str, ...]:
    """Axes the flat server merge shards over: all of them.  The merge
    works on a raveled (P,) view with no tensor structure left, so the P
    dim simply splits across every device of the mesh."""
    return tuple(mesh.shape.keys())


def shard_slices(length: int, mesh) -> List[Tuple[object, slice]]:
    """(device, part) for each device of ``mesh``: a dim of ``length``
    (already padded to a multiple of the mesh size) split into equal
    contiguous parts, in device order — the layout the JAX package's
    ``cohort_spec()`` gives a cohort dim and ``merge_spec()`` a P dim."""
    n = int(mesh.size)
    if length % n:
        raise ValueError(f"a dim of {length} does not split over {n} "
                         f"devices")
    part = length // n
    return [(dev, slice(i * part, (i + 1) * part))
            for i, dev in enumerate(mesh.devices)]
