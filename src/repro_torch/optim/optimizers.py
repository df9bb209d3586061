"""Optimizers as pure functions on params trees (dicts of tensors).

Functional API mirroring optax: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``.  Adam is written out as the JAX reference writes it
(fp32 moments, bias corrections taken in fp32) rather than through
``torch.optim.Adam``, whose rounding differs.

FedProx support: `proximal_grad` adds mu * (w - w_global) to the gradient,
which is the gradient of the paper's proximal term mu/2 ||w - w_global||^2.

DTensor params (the sharded train step) get DTensor moments laid out as
the params, and the elementwise passes of ``sgd``, ``adam`` and
``apply_updates`` run on each rank's local shards (``_on_shards``): grads,
moments and params of a leaf share one layout, so no pass communicates.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..core.flatten import tree_leaves, tree_map

Pytree = Any


class Optimizer(NamedTuple):
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], Tuple[Pytree, Pytree]]


def _on_shards(fn: Callable[..., torch.Tensor]) -> Callable:
    """``fn`` of tensors, run on the local shards when its first argument
    is a DTensor (every DTensor argument laid out as it), the result laid
    out as that argument; plain tensors pass through."""
    def run(lead, *rest):
        if not isinstance(lead, DTensor):
            return fn(lead, *rest)
        for t in rest:
            if isinstance(t, DTensor) and t.placements != lead.placements:
                raise ValueError(f"{t.placements} against {lead.placements}:"
                                 f" a leaf's grad, moments and param must "
                                 f"share a layout")
        out = fn(lead.to_local(), *(t.to_local() if isinstance(t, DTensor)
                                    else t for t in rest))
        return DTensor.from_local(out, lead.device_mesh, lead.placements,
                                  shape=lead.shape, stride=lead.stride())
    return run


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return tree_map(_on_shards(lambda p, u: p + u.to(p.dtype)), params,
                    updates)


def zeros_like_f32(params: Pytree) -> Pytree:
    """fp32 moment buffers shaped (and, for DTensors, laid out) like
    `params` (mixed-precision training and the server-side merge pipeline
    keep fp32 optimizer state even when the params themselves are lower
    precision)."""
    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params)


# --------------------------------------------------------------------------
def sgd(learning_rate: float, momentum: float = 0.0) -> Optimizer:
    """SGD, optionally with heavy-ball momentum. State: (count, velocity?)."""

    def init(params):
        if momentum == 0.0:
            return {"count": 0}
        return {"count": 0, "velocity": zeros_like_f32(params)}

    def update(grads, state, params=None):
        del params
        if momentum == 0.0:
            updates = tree_map(_on_shards(lambda g: -learning_rate
                                          * g.float()), grads)
            return updates, {"count": state["count"] + 1}
        vel = tree_map(_on_shards(lambda v, g: momentum * v + g.float()),
                       state["velocity"], grads)
        updates = tree_map(_on_shards(lambda v: -learning_rate * v), vel)
        return updates, {"count": state["count"] + 1, "velocity": vel}

    return Optimizer(init, update)


# --------------------------------------------------------------------------
def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when weight_decay > 0).

    m/v accumulators are fp32 regardless of param dtype.  The step count
    is a host integer, so the bias corrections cost no device sync.
    """

    def init(params):
        return {"count": 0, "m": zeros_like_f32(params),
                "v": zeros_like_f32(params)}

    def update(grads, state, params):
        count = state["count"] + 1
        cf = np.float32(count)
        m = tree_map(_on_shards(lambda m_, g: b1 * m_ + (1 - b1)
                                * g.float()), state["m"], grads)
        v = tree_map(_on_shards(lambda v_, g: b2 * v_ + (1 - b2)
                                * torch.square(g.float())),
                     state["v"], grads)
        bc1 = float(np.float32(1) - np.float32(b1) ** cf)
        bc2 = float(np.float32(1) - np.float32(b2) ** cf)

        def step(m_, v_, p):
            upd = -learning_rate * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd - learning_rate * weight_decay * p.float()
            return upd

        updates = tree_map(_on_shards(step), m, v, params)
        return updates, {"count": count, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(learning_rate: float, weight_decay: float = 0.01,
          **kw) -> Optimizer:
    return adam(learning_rate, weight_decay=weight_decay, **kw)


OPTIMIZERS = {"sgd": sgd, "adam": adam, "adamw": adamw}


def make_optimizer(name: str, learning_rate: float, **kw) -> Optimizer:
    try:
        return OPTIMIZERS[name](learning_rate, **kw)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}") from None


# --------------------------------------------------------------------------
def proximal_grad(grads: Pytree, params: Pytree, global_params: Pytree,
                  mu: float) -> Pytree:
    """FedProx: grad += mu * (w - w_global)  (gradient of mu/2||w - w_g||²)."""
    if mu == 0.0:
        return grads
    return tree_map(lambda g, p, gp: g + mu * (p - gp).to(g.dtype),
                    grads, params, global_params)


def global_norm(tree: Pytree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(grads: Pytree, max_norm: float) -> Pytree:
    """grads scaled by min(1, max_norm / (‖grads‖₂ + 1e-9)), the scale a
    device tensor (no host sync)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)
