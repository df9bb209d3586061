"""Mixture-of-Experts block: top-k routing with capacity-based dispatch.

The port of the JAX package's models/moe.py.  One-hot dispatch and
combine tensors (g, E, C) built from the router's fp32 logits, then dense
expert matmuls: the token groups' ``lax.scan`` becomes a Python loop, the
expert einsums ``torch.bmm`` over the expert axis.  Every expert runs on
its C capacity slots whether or not a token fills them, so a decode step
(C = 1) still reads every expert's weights, as the reference does.

Covers: llama4-maverick (128e top-1 + shared dense expert) and arctic
(128e top-2 + parallel dense-residual FFN) via ``cfg.parallel_dense_mlp``.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..sharding.spmd import (act_in, batch_placements, model_shard, region,
                             split_on, weight_in)
from .config import ArchConfig
from .layers import activation, gated_mlp, gated_mlp_init, he_init

Pytree = Any


def moe_init(gen: torch.Generator, cfg: ArchConfig,
             dtype=torch.float32) -> Pytree:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": he_init(gen, (D, E), D, torch.float32),  # router in fp32
         "wg": he_init(gen, (E, D, Fd), D, dtype),
         "wu": he_init(gen, (E, D, Fd), D, dtype),
         "wd": he_init(gen, (E, Fd, D), Fd, dtype)}
    if cfg.parallel_dense_mlp:
        p["dense"] = gated_mlp_init(gen, D, Fd, dtype)
    return p


def _capacity(group: int, top_k: int, n_experts: int, factor: float) -> int:
    c = int(group * top_k / n_experts * factor)
    return max(1, c)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last dim: the k largest, in descending
    order, ties to the lowest index (a stable sort; ``torch.topk`` leaves
    the order of ties unspecified)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _dispatch_combine(logits: torch.Tensor, top_k: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build (g,E,C) dispatch/combine tensors from router logits (g,E).

    Choice by choice, each token takes the next free slot of its expert
    (the occupancy runs on across choices); a token whose slot index
    reaches ``capacity`` is dropped: its row stays zero.  A dropped token
    writes a spare slot ``capacity`` that is cut off at the end, so every
    shape is static (no host sync, and fake tensors trace it)."""
    g, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = _top_k(probs, top_k)                      # (g, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    dispatch = torch.zeros((g, E, capacity + 1), device=logits.device)
    combine = torch.zeros((g, E, capacity + 1), device=logits.device)
    occupancy = torch.zeros((E,), dtype=torch.int64, device=logits.device)
    rows = torch.arange(g, device=logits.device)
    for choice in range(top_k):
        e = topi[:, choice]                                # (g,)
        mask_e = F.one_hot(e, E)                           # (g, E)
        pos = torch.cumsum(mask_e, dim=0) - 1 + occupancy[None, :]
        occupancy = occupancy + mask_e.sum(dim=0)
        slot = torch.clamp(pos.gather(1, e[:, None])[:, 0], max=capacity)
        # one 1 a token and choice: top_k's experts differ, so the choices
        # of a token never share a slot, and the kept writes are the
        # reference's sums of one-hot products
        dispatch[rows, e, slot] = 1.0
        combine[rows, e, slot] = topv[:, choice]
    return dispatch[..., :capacity], combine[..., :capacity]


def _experts(p: Pytree, xg: torch.Tensor, dispatch: torch.Tensor,
             combine: torch.Tensor, act: str) -> torch.Tensor:
    """One group's tokens xg (g, D) through the experts: gather into the
    (E, C, D) slots, each expert's gated MLP as a batched matmul, and
    combine back to (g, D), all in xg's dtype."""
    g, E, C = dispatch.shape
    dt = xg.dtype
    expert_in = (dispatch.to(dt).reshape(g, E * C).t() @ xg).reshape(E, C, -1)
    a = torch.bmm(expert_in, p["wg"].to(dt))
    u = torch.bmm(expert_in, p["wu"].to(dt))
    expert_out = torch.bmm(activation(a, act) * u, p["wd"].to(dt))
    return combine.to(dt).reshape(g, E * C) @ expert_out.reshape(E * C, -1)


def _routed(p: Pytree, x: torch.Tensor, cfg: ArchConfig, group: int,
            first: int = 0) -> torch.Tensor:
    """The routed experts' output for x (B, S, D): tokens in groups of
    ``group``, the last padded with zero rows.  ``p``'s expert stacks may
    hold a slice of the experts, from expert ``first`` on (the router
    always holds all of them): the result is then that slice's part of
    the sum."""
    B, S, D = x.shape
    T = B * S
    flat = x.reshape(T, D)
    n_groups = -(-T // group)
    pad = n_groups * group - T
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, D))])
    capacity = _capacity(group, cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor)
    router = p["router"].float()
    held = slice(first, first + p["wg"].shape[0])
    ys = []
    for xg in flat.reshape(n_groups, group, D):
        logits = xg.float() @ router                       # (g, E)
        dispatch, combine = _dispatch_combine(logits, cfg.top_k, capacity)
        ys.append(_experts(p, xg, dispatch[:, held], combine[:, held],
                           cfg.act))
    return torch.cat(ys)[:T].reshape(B, S, D)


def _routed_sharded(p: Pytree, x: DTensor, cfg: ArchConfig,
                    group: int) -> DTensor:
    """``_routed`` of DTensors as a ``local_map`` region.  Each rank
    routes whole groups, so every capacity slot comes out as in the
    unsharded block: its own batch shard's groups when the groups tile the
    shard, else (a group spans shards) every group, the tokens gathered
    first.  The experts are sharded over the model axis on their E dim:
    each rank runs its own experts on the slots routed to them, and the
    parts are summed over the axis."""
    mesh = x.device_mesh
    rows = batch_placements(x)
    shards = math.prod(mesh.size(i) for i, pl in enumerate(rows)
                       if isinstance(pl, Shard))
    if (x.shape[0] * x.shape[1] // shards) % group:
        rows = (Replicate(),) * mesh.ndim
    rank, _ = model_shard(mesh)
    experts = split_on(p["wg"], 0)
    keys = ("router", "wg", "wu", "wd")

    def local(x_l, *weights):
        first = rank * weights[1].shape[0] if experts != Replicate() else 0
        return _routed(dict(zip(keys, weights)), x_l, cfg, group, first)

    return region(local, [act_in(x), weight_in(p["router"])]
                  + [weight_in(p[k], experts) for k in keys[1:]],
                  Partial() if experts != Replicate() else Replicate(),
                  rows=rows)


def moe_block(p: Pytree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, D) → (B, S, D).  Tokens in groups of
    ``cfg.moe_group_size``, the last padded with zero rows; experts dense.
    DTensors (the sharded train step) route in a ``local_map`` region."""
    group = min(cfg.moe_group_size, x.shape[0] * x.shape[1])
    if isinstance(x, DTensor):
        y = _routed_sharded(p, x, cfg, group)
        y = y.redistribute(placements=batch_placements(x))
    else:
        y = _routed(p, x, cfg, group)
    if cfg.parallel_dense_mlp:
        y = y + gated_mlp(p["dense"], x, cfg.act)
    return y


def router_load(p: Pytree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Per-expert token counts (diagnostics / load-balance tests): each
    token's top-k experts by router logit, as the reference counts them
    (no capacity, no groups)."""
    logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
    _, topi = _top_k(logits, cfg.top_k)
    return torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
