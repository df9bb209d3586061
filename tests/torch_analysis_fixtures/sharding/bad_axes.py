# ruff: noqa
"""TORCH004 fixture: axis names that sharding/rules.py MESH_AXES does not
declare."""
from ..launch.mesh import AbstractMesh, Mesh
from .rules import P, _axis_size


def cohort_mesh(devices):
    return Mesh(devices, (("cohort", 2),))              # line 9: TORCH004


def host_mesh(devices):
    return Mesh(devices, (("data", 1), ("model", 2)))   # allowed: declared


def decode(q, mesh, seq_axis: str = "sequence"):        # line 16: TORCH004
    n = _axis_size(mesh, "workers")                     # line 17: TORCH004
    rows = mesh.shape["rows"]                           # line 18: TORCH004
    cols = mesh.shape.get("cols", 1)                    # line 19: TORCH004
    multi_pod = "pod" in mesh.shape                     # line 20: TORCH004
    spec = P(None, "model")                             # allowed: declared
    out = attend(q, mesh, batch_axis="batch")           # line 22: TORCH004
    return out, n, rows, cols, multi_pod, spec


def production():
    return AbstractMesh(axes=(("pod", 2), ("data", 16)))  # line 27: TORCH004
