"""The sharded train step: ``models.make_train_step`` placed on a device
mesh by the sharding specs, with DTensor as the SPMD partitioner.

The port of what the JAX package's launch/pretrain.py does around its
step (``param_specs`` / ``opt_specs`` / ``batch_specs``, ``to_named``,
``jax.jit(..., in_shardings=..., out_shardings=...)``).  Each rank of the
process group runs this code on its own shards (multi-controller, one
process a rank, as ``torchrun`` starts them):

* **state.**  ``init_state(gen)`` draws the params from the same
  generator stream as the unsharded ``init_state`` and lays each block
  out by ``param_specs`` as soon as it is made (``init_params``'s
  ``place``), so the sharded state holds the unsharded one's numbers and
  the host holds one block's leaves at a time (a leaf whose spec shards
  its stack dim, as the "moe" rule does to a MoE block's dense MLP, is
  placed once stacked).  Adam's moments are made
  laid out as their params, which is what ``opt_specs`` says; its step
  count stays a host int.
* **step.**  ``train_step(state, batch)`` lays the batch out by
  ``batch_specs`` (batch over the data axes) and runs the model's own
  step on DTensors.  DTensor places the matmuls, norms and elementwise
  ops; what it cannot place runs in ``local_map`` regions with explicit
  collectives over the model axis (the vocab-parallel embedding, head and
  loss, the scan, the MoE dispatch: sharding/spmd.py).  Grads come back
  laid out as their params, and Adam runs on the local shards.
* **constants.**  The model makes plain tensors of its own (positions,
  causal masks, RoPE tables, zero pads, the MoE's occupancy counts),
  equal on every rank.  The step runs under ``implicit_replication()``,
  which takes each such tensor as replicated, which is what it is: the
  alternative, making each a DTensor where it is built, would thread the
  mesh through every layer of the model for no change in numbers.

The loss comes back as a plain 0-d tensor, equal on every rank.  On one
rank (a (1, 1) mesh) every collective is over one member and the step
computes what the unsharded step computes.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..device import DeviceLike, resolve_device
from ..models import make_train_step
from ..models.config import ArchConfig
from ..sharding.rules import (DEFAULT_OPTIONS, ShardingOptions, batch_specs,
                              param_spec_for, place, placements_of, to_named)
from .mesh import abstract_mesh

Pytree = Any


def init_distributed(device: DeviceLike) -> bool:
    """Join the process group that ``torchrun`` (``python -m
    torch.distributed.run``) describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, the rendezvous address): NCCL on the
    cards, gloo on the CPU, each rank on card ``LOCAL_RANK``.  False, and
    nothing joined, when the process was started alone."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", device_id=card)
    else:
        dist.init_process_group("gloo")
    return True


def make_sharded_train_step(cfg: ArchConfig, device_mesh,
                            opts: ShardingOptions = DEFAULT_OPTIONS):
    """Returns ``(train_step, init_state)`` of ``make_train_step(cfg)``
    placed on ``device_mesh`` by the specs of ``opts`` (module docstring).
    ``init_state(gen)`` → the state as DTensors; ``train_step(state,
    batch)`` → ``(state, loss)``, the batch plain tensors (the whole
    batch, on every rank) or DTensors, the loss a plain 0-d tensor."""
    if cfg.single_mixer:
        raise ValueError(f"{cfg.name}: the sharded train step has no "
                         f"regions for grouped Mamba2 B/C and the "
                         f"single-mixer (NoPE attention, dropless MoE) "
                         f"blocks")
    mesh = abstract_mesh(device_mesh)
    names = device_mesh.mesh_dim_names
    step, init = make_train_step(cfg)

    def put(path, leaf, lead):
        if isinstance(leaf, DTensor):
            return leaf
        spec = param_spec_for(path, tuple(lead) + tuple(leaf.shape), mesh,
                              opts)
        if any(spec[:len(lead)]):
            return leaf         # it shards the stack dim: placed stacked
        return distribute_tensor(
            leaf, device_mesh, placements_of(spec[len(lead):], names),
            src_data_rank=None)

    def init_state(gen: torch.Generator) -> Pytree:
        return init(gen, place=put)

    def train_step(state: Pytree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Pytree, torch.Tensor]:
        if not all(isinstance(t, DTensor) for t in batch.values()):
            batch = place(batch, to_named(batch_specs(batch, mesh, opts),
                                          device_mesh))
        with implicit_replication():
            state, loss = step(state, batch)
        return state, loss.full_tensor()

    return train_step, init_state
