# ruff: noqa
"""TORCH004 fixture: the declared vocabulary, and one literal outside it."""
from typing import Tuple

CLIENT_AXIS = "clients"
MESH_AXES: Tuple[str, ...] = ("data", "model", CLIENT_AXIS)


class PartitionSpec(tuple):
    pass


P = PartitionSpec


def data_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)  # allowed


def logits_spec(mesh):
    return P("data", None, "tensor")    # line 21: TORCH004 ('tensor')
