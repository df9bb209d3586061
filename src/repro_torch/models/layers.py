"""Shared neural layers: norms, gated MLP, RoPE, embeddings, init.

The port of the JAX package's models/layers.py.  Init functions draw
from an explicit ``torch.Generator`` on that generator's device (the same
distributions as the reference, not its numbers).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..sharding.spmd import (act_in, batch_placements, model_dim,
                             model_shard, region, split_on, weight_in)

Pytree = Any


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ----------------------------------------------------------------- init
def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def he_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
            dtype=torch.float32) -> torch.Tensor:
    # the reference's precedence: (fan_in or shape[-2]) if 2-D or more
    fan_in = fan_in or shape[-2] if len(shape) >= 2 else shape[-1]
    scale = math.sqrt(2.0 / max(1, fan_in))
    # scaled in place: an expert stack's fp32 draw is 21 GB at full width
    return _normal(gen, shape).mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return _normal(gen, shape).mul_(0.02).to(dtype)


# ----------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to input dtype (gemma-style 1+scale)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ----------------------------------------------------------------- MLP
def gated_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                   dtype=torch.float32) -> Pytree:
    return {"wg": he_init(gen, (d_model, d_ff), d_model, dtype),
            "wu": he_init(gen, (d_model, d_ff), d_model, dtype),
            "wd": he_init(gen, (d_ff, d_model), d_ff, dtype)}


def activation(a: torch.Tensor, act: str) -> torch.Tensor:
    """``silu``; ``relu2``, relu(a)² (Nemotron-H's experts); or ``gelu``
    as the tanh approximation, as ``jax.nn.gelu`` computes it by
    default."""
    if act == "silu":
        return F.silu(a)
    if act == "relu2":
        return torch.square(F.relu(a))
    return F.gelu(a, approximate="tanh")


def gated_mlp(p: Pytree, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU: down( act(x@wg) * (x@wu) ).  On DTensors a
    ``local_map`` region, ``_gated_mlp_sharded``."""
    if isinstance(x, DTensor):
        return _gated_mlp_sharded(p, x, act)
    a = torch.einsum("...d,df->...f", x, p["wg"].to(x.dtype))
    u = torch.einsum("...d,df->...f", x, p["wu"].to(x.dtype))
    h = activation(a, act) * u
    return torch.einsum("...f,fd->...d", h, p["wd"].to(x.dtype))


def _gated_mlp_sharded(p: Pytree, x: DTensor, act: str) -> DTensor:
    """``gated_mlp`` of DTensor ``x`` as a ``local_map`` region, in the
    layout the specs give its weights: d_ff split over the model axis
    (wg, wu by columns, wd by rows; each rank's output its columns' part,
    all-reduced over the axis), the weights gathered over the data axes.
    Weights not split over the model axis run whole on every rank."""
    col = split_on(p["wg"], 1)
    row = Shard(0) if col == Shard(1) else Replicate()
    out = region(
        lambda x_l, wg, wu, wd: gated_mlp({"wg": wg, "wu": wu, "wd": wd},
                                          x_l, act),
        [act_in(x), weight_in(p["wg"], col), weight_in(p["wu"], col),
         weight_in(p["wd"], row)],
        Partial() if col == Shard(1) else Replicate())
    return out.redistribute(placements=batch_placements(x))


# ----------------------------------------------------------------- RoPE
def rope_frequencies(hd: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension (fraction of hd)."""
    rot = int(hd * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, hd); positions: broadcastable to (..., S).

    Applies rotary embedding to the first `fraction·hd` dims and passes the
    rest through (chatglm3's 2d/partial RoPE uses fraction=0.5).
    """
    hd = x.shape[-1]
    rot = int(hd * fraction) // 2 * 2
    if rot == 0:
        return x
    inv = rope_frequencies(hd, fraction, theta, x.device)        # (rot/2,)
    ang = positions[..., None].float() * inv                     # (...,S,rot/2)
    cos = torch.cos(ang)[..., None, :]                           # add head dim
    sin = torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ----------------------------------------------------------------- misc
def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping: cap · tanh(x / cap), in fp32."""
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       impl: str = "logsoftmax") -> torch.Tensor:
    """Mean token CE in fp32. logits (..., V), targets (...) int.

    impl='logsumexp' avoids materialising the full fp32 log-softmax tensor
    (nll = logsumexp(logits) − logits[target]); mathematically identical.
    """
    if isinstance(logits, DTensor):
        nll = _vocab_parallel_nll(logits, targets)
        if mask is not None:
            return torch.sum(nll * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
        return torch.mean(nll)
    lf = logits.float()
    idx = targets[..., None].long()
    if impl == "logsumexp":
        nll = (torch.logsumexp(lf, dim=-1)
               - torch.take_along_dim(lf, idx, dim=-1)[..., 0])
    else:
        logp = torch.log_softmax(lf, dim=-1)
        nll = -torch.take_along_dim(logp, idx, dim=-1)[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _nll_sum(h: torch.Tensor, head: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Summed token CE of h (T, D) through the untied head (D, V), in the
    logsumexp form, fp32."""
    lf = (h @ head.to(h.dtype)).float()
    return (torch.logsumexp(lf, dim=-1)
            - torch.take_along_dim(lf, labels[:, None].long(), dim=-1)[:, 0]
            ).sum()


def chunked_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, chunk: int,
                          remat: bool) -> torch.Tensor:
    """Mean token CE of hidden states h (..., D) through the untied head
    (D, V) against labels (...): the logsumexp form, ``chunk`` tokens at a
    time, so at most one chunk's (chunk, V) logits live at once; with
    ``remat`` each chunk keeps only its inputs and recomputes its logits
    in the backward pass.  The head is cast inside each chunk, so its
    gradient comes back in its own dtype and adds up there."""
    flat, targets = h.reshape(-1, h.shape[-1]), labels.reshape(-1)
    total = None
    for s in range(0, flat.shape[0], chunk):
        args = (flat[s:s + chunk], head, targets[s:s + chunk])
        part = (checkpoint(_nll_sum, *args, use_reentrant=False) if remat
                else _nll_sum(*args))
        total = part if total is None else total + part
    return total / flat.shape[0]


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of x, that dim split over the
    ranks of ``group`` (None: whole here), in torch's own arithmetic: the
    max (its infinities taken as 0), the sum of exp of the difference,
    log plus max, the max and the sum all-reduced over the group; the
    backward is torch's too, grad·exp(x − lse), on each rank's part.  So
    on one rank it equals ``torch.logsumexp`` bit for bit, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        top = x.amax(dim=-1, keepdim=True)
        if group is not None:
            dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        top = top.masked_fill(top.abs() == math.inf, 0.0)
        total = (x - top).exp().sum(dim=-1)
        if group is not None:
            dist.all_reduce(total, group=group)
        lse = total.log().add(top[..., 0])
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad[..., None] * (x - lse[..., None]).exp(), None


def _vocab_parallel_nll(logits: DTensor, targets) -> DTensor:
    """Token CE of DTensor logits (..., V), in fp32, as a ``local_map``
    region over the vocab's shards on the model axis: the logsumexp of
    all shards (``_LogSumExp``: the max and the sum of exp all-reduced
    over the axis), minus the target's logit, taken where a rank's shard
    holds it (0 elsewhere) and summed over the axis.  Logits not sharded
    on their vocab dim over the model axis take the same path whole."""
    mesh = logits.device_mesh
    vocab = split_on(logits, logits.dim() - 1)
    sharded = vocab != Replicate()
    group = mesh.get_group(model_dim(mesh)) if sharded else None
    rank, _ = model_shard(mesh)

    def local(lf, t):
        lf = lf.float()
        n = lf.shape[-1]
        idx = t.long() - rank * n if sharded else t.long()
        inside = (idx >= 0) & (idx < n)
        picked = torch.take_along_dim(lf, idx.clamp(0, n - 1)[..., None],
                                      dim=-1)[..., 0]
        return _LogSumExp.apply(lf, group), torch.where(inside, picked, 0.0)

    lse, picked = region(local, [act_in(logits, vocab), act_in(targets)],
                         (Replicate(), Partial() if sharded else Replicate()))
    return lse - picked.redistribute(placements=batch_placements(logits))
