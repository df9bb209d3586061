"""The sharded train step's ``local_map`` regions: one builder, ``region``.

The sharded step (launch/sharded.py) runs the model's own code on
DTensors, and DTensor places most of it.  What it cannot place runs as a
``local_map`` region: a function on each rank's local tensors (the
vocab-parallel embedding, head and loss of models/transformer.py and
models/layers.py, the attention, MLP and conv blocks, the scan of
kernels/ssd_scan.py, the MoE routing of models/moe.py).

A site states one layout: its inputs, each an activation (``act_in``:
its rows of the batch) or a weight (``weight_in``: whole on the batch
axes), with its placement on the mesh's "model" axis, and each output's
placement on that axis.  Every other axis ("pod", "data") carries the
batch: there an activation keeps ``Shard(0)`` where the batch is split,
else it is replicated.  ``region`` derives how the inputs' local grads add up:

* an input split over an axis (``Shard``) gets its grad split alike;
* an input whole on an axis the region's work is split over gets a part
  of its grad on each rank there: ``Partial()``.  The work is split over
  a batch axis where the rows are, and over the model axis where any
  input is;
* elsewhere every rank computes the whole grad: ``Replicate()``.

The second rule holds where each rank's outputs are its part of the
result on the axes its work is split over (``Shard`` or ``Partial``), or
where a region all-reduces an output itself and its backward hands each
rank only its own part (the loss's ``_LogSumExp``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import local_map

MODEL_AXIS = "model"


def model_dim(device_mesh) -> Optional[int]:
    """The mesh dim of the "model" axis, or None if the mesh has none."""
    names = tuple(device_mesh.mesh_dim_names or ())
    return names.index(MODEL_AXIS) if MODEL_AXIS in names else None


def model_shard(device_mesh) -> Tuple[int, int]:
    """(this rank's coordinate on the model axis, the axis' size); (0, 1)
    without one."""
    dim = model_dim(device_mesh)
    if dim is None:
        return 0, 1
    return device_mesh.get_local_rank(dim), device_mesh.size(dim)


def split_on(t: DTensor, dim: int) -> Placement:
    """``Shard(dim)`` if ``t`` is split over the model axis on tensor dim
    ``dim``, else ``Replicate()`` (a region then gathers it whole)."""
    mdim = model_dim(t.device_mesh)
    on = Shard(dim)
    return on if mdim is not None and t.placements[mdim] == on \
        else Replicate()


def batch_placements(t: DTensor) -> Tuple[Placement, ...]:
    """``t``'s rows: its placements on the batch axes (a ``Shard(0)``
    kept, anything else replicated), replicated on the model axis."""
    mdim = model_dim(t.device_mesh)
    return tuple(p if i != mdim and isinstance(p, Shard) and p.dim == 0
                 else Replicate() for i, p in enumerate(t.placements))


class Input(NamedTuple):
    tensor: object               # a DTensor, or a plain tensor (replicated)
    model: Placement             # its placement on the model axis
    rows: bool                   # an activation (True) or a weight


def act_in(t, model: Placement = Replicate()) -> Input:
    """An activation input: the region's rows of the batch, ``model`` on
    the model axis."""
    return Input(t, model, True)


def weight_in(t, model: Placement = Replicate()) -> Input:
    """A weight input: whole on the batch axes, ``model`` on the model
    axis."""
    return Input(t, model, False)


def region(fn: Callable, inputs: Sequence[Input],
           out: Union[Placement, Tuple[Placement, ...]],
           rows: Optional[Sequence[Placement]] = None):
    """``fn`` of the inputs' local tensors as a ``local_map`` region (the
    module docstring).  ``out`` is the output's placement on the model
    axis, or a tuple of them for a tuple of outputs; on the batch axes
    every output lies as ``rows`` (default: the first activation's rows).
    A plain tensor input is taken as replicated."""
    like = next(i.tensor for i in inputs if isinstance(i.tensor, DTensor))
    mesh = like.device_mesh
    mdim = model_dim(mesh)
    if rows is None:
        first = next(i.tensor for i in inputs if i.rows)
        rows = batch_placements(as_dtensor(first, like))
    split = [isinstance(p, Shard) for p in rows]
    if mdim is not None:
        split[mdim] = any(isinstance(i.model, Shard) for i in inputs)

    def lay(model: Placement, is_rows: bool = True) -> Tuple[Placement, ...]:
        return tuple(model if d == mdim else rows[d] if is_rows
                     else Replicate() for d in range(mesh.ndim))

    def grad(pl: Tuple[Placement, ...]) -> Tuple[Placement, ...]:
        return tuple(p if isinstance(p, Shard) else
                     Partial() if split[d] else Replicate()
                     for d, p in enumerate(pl))

    in_pl = tuple(lay(i.model, i.rows) for i in inputs)
    out_pl = (tuple(lay(o) for o in out) if isinstance(out, tuple)
              else list(lay(out)))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=tuple(map(grad, in_pl)),
                     device_mesh=mesh, redistribute_inputs=True)(
        *(as_dtensor(i.tensor, like) for i in inputs))


def as_dtensor(t, like: DTensor) -> DTensor:
    """``t`` as a DTensor on ``like``'s mesh: a plain tensor (made whole on
    every rank) is taken as replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh,
                              [Replicate()] * like.device_mesh.ndim,
                              run_check=False)


def unsharded_on(t, dim: int):
    """``t`` with tensor dim ``dim`` whole on every rank (a DTensor sharded
    there is gathered over those mesh dims); anything else as it is."""
    if not isinstance(t, DTensor) or Shard(dim) not in t.placements:
        return t
    return t.redistribute(placements=[Replicate() if p == Shard(dim) else p
                                      for p in t.placements])
