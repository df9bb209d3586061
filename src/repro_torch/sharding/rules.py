"""Mesh-axis vocabulary, the slicing rules of the sharded FL paths, and
the large-model sharding rules.

The port of the JAX package's sharding/rules.py.  The FL half: the
declared axis names, ``merge_axes`` (the flat server merge splits its P
dim over every axis of its mesh) and, standing in for ``cohort_spec()``
and ``merge_spec()``, ``shard_slices``: one contiguous equal slice of a
dim per mesh device, in device order, for the vectorized executor's
padded cohort dim K and the merge's padded P dim.

The large-model half (FSDP + TP, MaxText-flavoured), pure functions of
key paths, shapes and a mesh's ``.shape`` (axis name → size):

  * every weight gets a 'model' (tensor-parallel) dim — heads / ff /
    experts / vocab — picked from an ordered candidate list, skipping
    candidates whose size does not divide the mesh axis;
  * a second dim is sharded over the data axes (FSDP): ('pod', 'data')
    on the multi-pod mesh;
  * batches shard their batch dim over the data axes;
  * decode KV caches shard the sequence dim over 'model' (the flash-
    decoding layout) and the batch over data when it divides.

A dim that does not divide falls through to the next candidate or stays
replicated.  A spec is a ``PartitionSpec``: a tuple with one entry a dim,
``None``, an axis name or a tuple of names, equal to the JAX package's
``PartitionSpec`` with the same entries.  ``shard_shape`` gives the
per-device shape a spec implies, which the dry run (launch/dryrun.py)
counts.  Path names are the nested dict keys of the port's trees, which
keep the reference's keys (convert.py).

The port's SPMD partitioner is DTensor (``torch.distributed.tensor``) over
a ``DeviceMesh`` with the same axis names (launch/mesh.py
``to_device_mesh``).  ``to_named`` turns each spec into the placements it
implies, one a mesh dim: ``Shard(d)`` on every axis that names tensor dim
``d``, ``Replicate()`` on the others; ``place`` lays a tree out by them
and ``gather`` brings it back whole.  Every dim the rules shard divides
its axes' product, so each rank's local shape is ``shard_shape``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

Pytree = Any

# the declared mesh-axis names:
#   pod / data / model : the production FSDP+TP mesh (launch/mesh.py
#                        make_production_mesh); data / model also name the
#                        host mesh of the P-sharded merge (make_host_mesh)
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


# ================================================== large-model rules
class PartitionSpec(tuple):
    """One entry a dim: ``None`` (replicated), an axis name, or a tuple
    of axis names (the dim split over their product)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class ShardingOptions:
    """Knobs of the sharding strategy (launch/variants.py).

    use_model_axis   : False → pure data parallelism; params are only
                       FSDP-sharded over the data axes (right for models
                       whose optimizer state fits on one device).
    attn_model       : False → attention projections are not model-sharded
                       (archs with fewer heads than the model axis).
    batch_over_model : also shard the batch dim over 'model' (pure-DP mode
                       turns the whole mesh into one big data axis).
    replicate_params : fully replicate parameters (pure DP for models that
                       fit on one device).
    """
    use_model_axis: bool = True
    attn_model: bool = True
    batch_over_model: bool = False
    replicate_params: bool = False


DEFAULT_OPTIONS = ShardingOptions()


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def data_axes(mesh) -> Tuple[str, ...]:
    """The (outer) data-parallel axes: ('pod', 'data') when multi-pod."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _pick_spec(shape: Sequence[int], mesh, model_cands: Sequence[int],
               data_cands: Sequence[int],
               model_axis: str = "model") -> PartitionSpec:
    """Assign 'model' to the first divisible candidate dim (negative
    indices from the end), then the FSDP axes to another dim."""
    spec: list = [None] * len(shape)
    msize = _axis_size(mesh, model_axis)
    for d in model_cands:
        i = d % len(shape)
        if shape[i] > 0 and shape[i] % msize == 0 and spec[i] is None:
            spec[i] = model_axis
            break
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    for d in data_cands:
        i = d % len(shape)
        if shape[i] > 0 and shape[i] % dsize == 0 and spec[i] is None:
            spec[i] = daxes if len(daxes) > 1 else daxes[0]
            break
    return P(*spec)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, or () for a host scalar (the port's
    optimizer step count)."""
    return tuple(getattr(leaf, "shape", ()))


def _map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree,
                   path: Tuple[str, ...] = ()):
    """A tree shaped like ``tree`` whose leaves are ``fn(path, leaf)``;
    dict keys (and list positions) make the path."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree, path: Tuple[str, ...] = ()):
    """``(path, leaf)`` for each leaf of ``tree``, with the paths and in the
    order of ``_map_with_path``; a ``PartitionSpec`` is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and \
            not isinstance(tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


# ------------------------------------------------------------------ params
def param_spec_for(path_names: Sequence[str], shape: Sequence[int], mesh,
                   opts: ShardingOptions = DEFAULT_OPTIONS) -> PartitionSpec:
    """Sharding for one parameter leaf, by name + context + shape."""
    name = path_names[-1]
    ctx = set(path_names)

    if name in ("ln1", "ln2", "lnx", "final_norm", "norm", "conv_b",
                "xgate", "A_log", "dt_bias", "D", "count"):
        return P()
    if opts.replicate_params:
        return P()
    if not opts.use_model_axis:
        # pure-DP / FSDP-only: shard a trailing dim over data (never the
        # leading stacked-layer dim)
        return _pick_spec(shape, mesh, model_cands=(),
                          data_cands=tuple(range(-1, -len(shape), -1))
                          or (-1,))
    if not opts.attn_model and name in ("wq", "wk", "wv", "wo"):
        return _pick_spec(shape, mesh, model_cands=(),
                          data_cands=(-3,) if name != "wo" else (-1,))
    if name == "embed":
        return _pick_spec(shape, mesh, model_cands=(-2,), data_cands=(-1,))
    if name in ("head", "router"):
        return _pick_spec(shape, mesh, model_cands=(-1,), data_cands=(-2,))
    if name in ("wq", "wk", "wv"):          # (..., D, H, hd)
        return _pick_spec(shape, mesh, model_cands=(-2, -1),
                          data_cands=(-3,))
    if name == "wo":                         # (..., H, hd, D)
        return _pick_spec(shape, mesh, model_cands=(-3, -2),
                          data_cands=(-1,))
    if name in ("wg", "wu"):
        if "moe" in ctx:                     # (..., E, D, F)
            return _pick_spec(shape, mesh, model_cands=(-3,),
                              data_cands=(-1,))
        return _pick_spec(shape, mesh, model_cands=(-1,), data_cands=(-2,))
    if name == "wd":
        if "moe" in ctx:                     # (..., E, F, D)
            return _pick_spec(shape, mesh, model_cands=(-3,),
                              data_cands=(-2,))
        return _pick_spec(shape, mesh, model_cands=(-2,), data_cands=(-1,))
    if name in ("up", "down") and "moe" in ctx:
        # a 'moe' block's experts (..., E, D, F) and (..., E, F, D): E over
        # the model axis; its shared expert (D, Fs) and (Fs, D): Fs
        if "shared" in ctx:
            return _pick_spec(shape, mesh,
                              model_cands=(-1,) if name == "up" else (-2,),
                              data_cands=(-2,) if name == "up" else (-1,))
        return _pick_spec(shape, mesh, model_cands=(-3,),
                          data_cands=(-1,) if name == "up" else (-2,))
    if name == "in_proj":                    # (..., D, d_in_proj)
        return _pick_spec(shape, mesh, model_cands=(-1,), data_cands=(-2,))
    if name == "out_proj":                   # (..., d_inner, D)
        return _pick_spec(shape, mesh, model_cands=(-2,), data_cands=(-1,))
    if name == "conv_w":                     # (..., conv_dim, K)
        return _pick_spec(shape, mesh, model_cands=(-2,), data_cands=())
    return P()                               # fallback: replicate


def param_specs(tree: Pytree, mesh,
                opts: ShardingOptions = DEFAULT_OPTIONS) -> Pytree:
    return _map_with_path(
        lambda path, leaf: param_spec_for(path, _shape(leaf), mesh, opts),
        tree)


def opt_specs(opt_state: Pytree, params_specs_tree: Pytree, mesh,
              opts: ShardingOptions = DEFAULT_OPTIONS) -> Pytree:
    """Optimizer state mirrors param sharding (m/v); scalars replicate:
    the port's step count is a host int, spec ``()``."""
    del params_specs_tree

    def one(path, leaf):
        if path and path[0] in ("m", "v"):
            return param_spec_for(path[1:], _shape(leaf), mesh, opts)
        return P()
    return _map_with_path(one, opt_state)


# ------------------------------------------------------------------ batch
def batch_specs(batch: Pytree, mesh,
                opts: ShardingOptions = DEFAULT_OPTIONS) -> Pytree:
    """Shard batch dims over the data axes; everything else replicated."""
    daxes = data_axes(mesh)
    if opts.batch_over_model:
        daxes = daxes + ("model",)

    def one(path, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        # largest prefix of the data axes that divides the batch dim
        axes = list(daxes)
        while axes and shape[0] % _axis_size(mesh, tuple(axes)) != 0:
            axes.pop()
        if not axes:
            return P(*([None] * len(shape)))
        dspec = tuple(axes) if len(axes) > 1 else axes[0]
        return P(dspec, *([None] * (len(shape) - 1)))
    return _map_with_path(one, batch)


# ------------------------------------------------------------------ cache
def cache_spec_for(path_names: Sequence[str], shape: Sequence[int],
                   mesh) -> PartitionSpec:
    """Decode-cache sharding: KV seq over 'model' (flash-decode layout),
    batch over data when divisible; SSM states shard heads/P over model."""
    name = path_names[-1]
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    dspec = daxes if len(daxes) > 1 else daxes[0]
    msize = _axis_size(mesh, "model")
    spec: list = [None] * len(shape)

    if name in ("k", "v"):       # (L, B, K, S, hd) or (B, K, S, hd)
        b, s = len(shape) - 4, len(shape) - 2
        if shape[b] % dsize == 0:
            spec[b] = dspec
        if shape[s] % msize == 0:
            spec[s] = "model"
        return P(*spec)
    if name in ("ck", "cv"):     # (L, B, P, K, hd)
        b = len(shape) - 4
        if shape[b] % dsize == 0:
            spec[b] = dspec
        return P(*spec)
    if name == "conv":           # (L, B, K-1, conv_dim)
        b, c = len(shape) - 3, len(shape) - 1
        if shape[b] % dsize == 0:
            spec[b] = dspec
        if shape[c] % msize == 0:
            spec[c] = "model"
        return P(*spec)
    if name == "ssm":            # (L, B, H, P, N)
        b, h, p = len(shape) - 4, len(shape) - 3, len(shape) - 2
        if shape[b] % dsize == 0:
            spec[b] = dspec
        if shape[h] % msize == 0:
            spec[h] = "model"
        elif shape[p] % msize == 0:
            spec[p] = "model"
        return P(*spec)
    return P()


def cache_specs(cache: Pytree, mesh,
                opts: ShardingOptions = DEFAULT_OPTIONS) -> Pytree:
    del opts
    return _map_with_path(
        lambda path, leaf: cache_spec_for(path, _shape(leaf), mesh), cache)


# ------------------------------------------------------------------ logits
def logits_spec(mesh) -> PartitionSpec:
    daxes = data_axes(mesh)
    dspec = daxes if len(daxes) > 1 else daxes[0]
    return P(dspec, None, "model")


def shard_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``
    on ``mesh``: each sharded dim divided by its axes' product (rounded
    up, as a padded shard would be)."""
    out = list(shape)
    for i, axis in enumerate(spec):
        n = _axis_size(mesh, axis)
        out[i] = -(-out[i] // n)
    return tuple(out)


# ------------------------------------------------------------------ placement
@dataclass(frozen=True)
class NamedSharding:
    """A spec on a ``DeviceMesh``, the counterpart of
    ``jax.sharding.NamedSharding``: ``placements`` are DTensor's, one a
    mesh dim."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_of(self.spec, self.mesh.mesh_dim_names)


def placements_of(spec: Sequence, axis_names: Sequence[str]) -> tuple:
    """The DTensor placements ``spec`` implies on a mesh whose dims are
    ``axis_names``: ``Shard(d)`` on each axis that names tensor dim ``d``,
    ``Replicate()`` on the rest.  An entry of several axes shards its dim
    over each of them, the first named the outer split, as JAX splits it;
    DTensor splits a dim over mesh dims in mesh order, so such an entry
    must name its axes in that order."""
    names = tuple(axis_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"{spec} names axes {missing} that the mesh "
                             f"{names} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec} splits dim {dim} over {axes}, against "
                             f"the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec} shards two dims over {names[i]!r}")
            out[i] = Shard(dim)
    return tuple(out)


def _map_specs(fn: Callable[[Any], Any], tree):
    """``tree`` with each ``PartitionSpec`` leaf replaced by ``fn`` of it."""
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_specs(fn, v) for v in tree)
    return fn(tree)


def to_named(tree_specs: Pytree, device_mesh) -> Pytree:
    """Each spec of ``tree_specs`` as a ``NamedSharding`` on
    ``device_mesh``, the reference's ``to_named``."""
    return _map_specs(lambda s: NamedSharding(device_mesh, s), tree_specs)


def place(tree: Pytree, shardings: Pytree) -> Pytree:
    """``tree``'s tensors as DTensors laid out by the matching
    ``NamedSharding`` of ``shardings``; a host scalar (the optimizer's step
    count, spec ``()``) stays as it is.  Every rank holds the same whole
    tensor (made from the same seed), so each keeps its own shard and
    nothing is sent."""
    def one(leaf, sh):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf, sh.mesh, sh.placements,
                                 src_data_rank=None)

    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    return one(tree, shardings)


def gather(tree: Pytree) -> Pytree:
    """``tree`` with every DTensor gathered whole onto each rank."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree
