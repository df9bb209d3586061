"""Mixture-of-Experts block: top-k routing with capacity-based dispatch.

The port of the JAX package's models/moe.py.  One-hot dispatch and
combine tensors (g, E, C) built from the router's fp32 logits, then dense
expert matmuls: the token groups' ``lax.scan`` becomes a Python loop, the
expert einsums ``torch.bmm`` over the expert axis.  Every expert runs on
its C capacity slots whether or not a token fills them, so a decode step
(C = 1) still reads every expert's weights, as the reference does.

Covers: llama4-maverick (128e top-1 + shared dense expert) and arctic
(128e top-2 + parallel dense-residual FFN) via ``cfg.parallel_dense_mlp``.

``moe_layer`` is the port's own, with no JAX counterpart: the mixer of a
'moe' block (Nemotron-H's 'E' layers).  Router logits x·W in fp32,
sigmoid scores s, the k experts chosen by s + ``router_bias`` (the
correction bias steers the choice only), their weights s normalised to
sum 1 and scaled by ``cfg.routed_scale``.  Dispatch is dropless: the
token-expert pairs that fall on the held experts are sorted by expert
and the held experts' non-gated MLPs down(act(up(x))) run as two grouped
matrix products (``torch._grouped_mm``), each expert on its own
contiguous rows (one host sync a layer, for the pairs' count); the
weighted rows are added back to their tokens.  A shared expert, if any,
runs on every token.  The layer holds experts ``first`` .. ``first + held
− 1`` of ``n_experts`` and routes over all of them: its output is those
experts' part of the routed sum (plus the shared expert), as one card of
an expert-parallel layer computes it without the exchange.  Under tracing: the span ``moe`` (the
layer's forward), ``moe.experts`` (the held experts' products) and the
counters ``moe.routed_pairs`` and ``moe.max_expert_rows``.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .. import tracing
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


# ============================================================ 'moe' blocks
def moe_layer_init(gen: torch.Generator, cfg: ArchConfig,
                   dtype=torch.float32) -> Pytree:
    """A 'moe' block's mixer: the router (D, E) and its correction bias
    (E,) in fp32 (the bias starts at zero and takes no gradient: it only
    steers the choice), the held experts' ``up`` (held, D, F) and
    ``down`` (held, F, D), and the shared expert's."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": he_init(gen, (D, E), D, torch.float32),
         "router_bias": torch.zeros((E,), dtype=torch.float32,
                                    device=gen.device),
         "up": he_init(gen, (cfg.n_held, D, Fd), D, dtype),
         "down": he_init(gen, (cfg.n_held, Fd, D), Fd, dtype)}
    if cfg.shared_expert_ff:
        Fs = cfg.shared_expert_ff
        p["shared"] = {"up": he_init(gen, (D, Fs), D, dtype),
                       "down": he_init(gen, (Fs, D), Fs, dtype)}
    return p


def route(p: Pytree, x: torch.Tensor, cfg: ArchConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, k) fp32, experts (T, k)) of tokens x (T, D) over all
    ``cfg.n_experts`` experts (module docstring)."""
    scores = torch.sigmoid(x.float() @ p["router"].float())
    _, experts = torch.topk(scores + p["router_bias"].float(), cfg.top_k,
                            dim=-1)
    w = scores.gather(1, experts)
    return w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale, experts


def _mlp(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
         act: str) -> torch.Tensor:
    """A non-gated expert: down(act(x·up))."""
    return activation(x @ up.to(x.dtype), act) @ down.to(x.dtype)


class _HostCopy:
    """A small device tensor's copy to the host, started at once and waited
    for in ``tolist``.  On a card the wait is for the copy alone (an event
    behind it, into pinned memory), so the work queued after the copy keeps
    the card busy while the host waits and then issues what comes next."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        self.host = t
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()

    def tolist(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return self.host.tolist()


def moe_layer(p: Pytree, x: torch.Tensor, cfg: ArchConfig,
              first: int = 0) -> torch.Tensor:
    """A 'moe' block's mixer, x (B, S, D) → (B, S, D): the held experts'
    part of the routed sum, from expert ``first`` on, dropless (every pair
    routed to a held expert is computed), plus the shared expert on every
    token.  The pairs are sorted by held expert, those of other experts
    last; the held experts' row counts are the one host sync, and the
    shared expert is queued before it is waited for."""
    B, S, D = x.shape
    held = p["up"].shape[0]
    with tracing.span("moe"):
        flat = x.reshape(B * S, D)
        weights, experts = route(p, flat, cfg)
        local = experts.reshape(-1) - first
        local = torch.where((local >= 0) & (local < held), local, held)
        local, order = torch.sort(local, stable=True)
        counts = torch.bincount(local, minlength=held + 1)
        pending = _HostCopy(counts)
        ends = torch.cumsum(counts[:held], 0).to(torch.int32)
        y = (_mlp(flat, p["shared"]["up"], p["shared"]["down"], cfg.act)
             if "shared" in p else torch.zeros_like(flat))
        rows = pending.tolist()[:held]
        pairs = sum(rows)
        tracing.count("moe.routed_pairs", pairs)
        tracing.count("moe.max_expert_rows", max(rows, default=0))
        if not pairs:
            return y.reshape(B, S, D)
        order = order[:pairs]
        token = torch.div(order, cfg.top_k, rounding_mode="floor")
        xs = flat[token]
        with tracing.span("moe.experts"):
            # one grouped product a projection: held expert e takes rows
            # ends[e - 1]:ends[e]
            h = torch._grouped_mm(xs, p["up"].to(x.dtype), offs=ends)
            ys = torch._grouped_mm(activation(h, cfg.act),
                                   p["down"].to(x.dtype), offs=ends)
        w = weights.reshape(-1)[order]
        y = y.index_add(0, token, ys * w[:, None].to(ys.dtype))
        return y.reshape(B, S, D)
