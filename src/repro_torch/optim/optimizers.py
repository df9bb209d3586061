"""Optimizers as pure functions on params trees (dicts of tensors).

Functional API mirroring optax: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``; apply with
``apply_updates``.  Adam is written out as the JAX reference writes it
(fp32 moments, bias corrections taken in fp32) rather than through
``torch.optim.Adam``, whose rounding differs.

FedProx support: `proximal_grad` adds mu * (w - w_global) to the gradient,
which is the gradient of the paper's proximal term mu/2 ||w - w_global||^2.

``Optimizer.step(grads, state, params, anchor=None, mu=0.0)`` is the whole
local step: the proximal term, the update and its apply.  Adam and AdamW
run it through ``kernels.adam`` (one pass over each leaf's memory on the
card, PyTorch's passes on the CPU; the same bits either way), and so does
their ``update``; other optimizers compose ``proximal_grad``, ``update``
and ``apply_updates``.

DTensor params (the sharded train step) get DTensor moments laid out as
the params, and the elementwise passes of ``sgd``, ``adam`` and
``apply_updates`` run on each rank's local shards (``_on_shards``): grads,
moments and params of a leaf share one layout, so no pass communicates.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import kernels
from ..core.flatten import tree_leaves, tree_map

Pytree = Any


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``; ``fused_step``: the whole of ``step`` in one call,
    or None, where ``step`` composes ``proximal_grad``, ``update`` and
    ``apply_updates``.  An optimizer built anew around another ``update``
    (``Optimizer(opt.init, wrapped)``) has none, so the wrapped update
    runs."""
    init: Callable[[Pytree], Pytree]
    update: Callable[[Pytree, Pytree, Pytree], Tuple[Pytree, Pytree]]
    fused_step: Optional[Callable[..., Tuple[Pytree, Pytree]]] = None

    def step(self, grads: Pytree, state: Pytree, params: Pytree,
             anchor: Optional[Pytree] = None, mu: float = 0.0
             ) -> Tuple[Pytree, Pytree]:
        """One local step: ``grads`` plus the FedProx term mu·(params −
        anchor) when mu ≠ 0, the update, and its apply.  Returns
        ``(params, state)``, both new."""
        if mu != 0.0 and anchor is None:
            raise ValueError("a FedProx step (mu != 0) needs the anchor "
                             "params")
        if self.fused_step is not None:
            return self.fused_step(grads, state, params, anchor, mu)
        grads = proximal_grad(grads, params, anchor, mu)
        updates, state = self.update(grads, state, params)
        return apply_updates(params, updates), state


def _local(lead, rest) -> list:
    """The local shards of ``rest`` when ``lead`` is a DTensor (each
    DTensor of ``rest`` laid out as it); plain tensors pass through."""
    if not isinstance(lead, DTensor):
        return list(rest)
    for t in rest:
        if isinstance(t, DTensor) and t.placements != lead.placements:
            raise ValueError(f"{t.placements} against {lead.placements}: a "
                             f"leaf's grad, moments and param must share a "
                             f"layout")
    return [t.to_local() if isinstance(t, DTensor) else t for t in rest]


def _laid_out_as(out: torch.Tensor, lead) -> torch.Tensor:
    """``out`` (a local tensor) as a DTensor laid out as ``lead``, when
    ``lead`` is one."""
    if not isinstance(lead, DTensor):
        return out
    return DTensor.from_local(out, lead.device_mesh, lead.placements,
                              shape=lead.shape, stride=lead.stride())


def _on_shards(fn: Callable[..., torch.Tensor]) -> Callable:
    """``fn`` of tensors, run on the local shards when its first argument
    is a DTensor (every DTensor argument laid out as it), the result laid
    out as that argument; plain tensors pass through."""
    def run(lead, *rest):
        return _laid_out_as(fn(*_local(lead, (lead, *rest))), lead)
    return run


def apply_updates(params: Pytree, updates: Pytree) -> Pytree:
    return tree_map(_on_shards(lambda p, u: p + u.to(p.dtype)), params,
                    updates)


def _tree_like(tree: Pytree, leaves: List[torch.Tensor]) -> Pytree:
    """A tree shaped like ``tree`` holding ``leaves`` in ``tree_map``'s
    order of its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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

    def run(grads, state, params, anchor, mu, apply):
        """``kernels.adam`` over the tree's leaves (each DTensor leaf's
        local shards); returns (new params or updates, state)."""
        count = state["count"] + 1
        cf = np.float32(count)
        bc1 = float(np.float32(1) - np.float32(b1) ** cf)
        bc2 = float(np.float32(1) - np.float32(b2) ** cf)
        trees = [params, grads, state["m"], state["v"]]
        prox = mu != 0.0
        if prox:
            trees.append(anchor)
        rows: List[tuple] = []
        tree_map(lambda *leaf: rows.append(leaf), *trees)
        cols = list(zip(*(_local(row[0], row) for row in rows))) or \
            [()] * len(trees)
        outs = kernels.adam(
            *cols[:4], lr=learning_rate, b1=b1, b2=b2, eps=eps,
            weight_decay=weight_decay, bc1=bc1, bc2=bc2,
            anchor=cols[4] if prox else None, mu=mu, apply=apply)
        out, m, v = (_tree_like(params, [_laid_out_as(t, row[0])
                                         for t, row in zip(col, rows)])
                     for col in outs)
        return out, {"count": count, "m": m, "v": v}

    def update(grads, state, params):
        return run(grads, state, params, None, 0.0, apply=False)

    def step(grads, state, params, anchor, mu):
        return run(grads, state, params, anchor, mu, apply=True)

    return Optimizer(init, update, step)


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
