"""Plain reference of Nemotron-H (NVIDIA Nemotron 3 Nano 30B-A3B) at the
benchmark's cut, in float32, and its weights from the seed.

Per layer x + mixer(rmsnorm(x)), the mixer given by the layer's letter
of ``hybrid_override_pattern`` (the first ``num_hidden_layers``):
  M  Mamba2: in_proj → (z, xBC, dt); xBC through a depthwise causal conv
     with bias and SiLU, split into x, B, C (B, C in ``n_groups`` groups of
     ``ssm_state_size``); dt = softplus(dt + dt_bias), A = −exp(A_log);
     the SSD of each group's heads against its B and C (``models.ssd``,
     the paper's minimal chunked algorithm, chunk ``chunk_size``);
     y + D·x; RMSNorm of y·silu(z) per group of d_inner / n_groups
     channels; out_proj;
  *  attention: q, k, v, o without bias, each KV head shared by its query
     heads, causal softmax of q·kᵀ/√hd, no positional encoding;
  E  MoE: logits x·W, s = sigmoid(logits), the top ``num_experts_per_tok``
     of s + bias chosen over all the router's experts, weights s / Σs ×
     ``routed_scaling_factor``; each chosen expert held here adds its
     down(relu(up(x))²) times its weight at its tokens; the shared expert
     down(relu(up(x))²) on every token;
then a final RMSNorm and the untied head; the loss is the mean token CE.

Departures from the published modelling code (transformers'
``modeling_nemotron_h``), none of which changes the function: RMSNorm
scales by (1 + w) with w stored from zero (published: the scale, from
one); the correction bias is a leaf of the tree (published: a buffer);
only the held experts (the first ``n_routed_experts`` of the router's
``model.router_experts``) add to the routed sum, as one card of the
stated expert-parallel deployment computes it; float32 throughout.

Computed so that it fits one card beside its Adam state: a sequence at a
time (``train.lm_step_grads``' order), each layer, each block of
``Q_BLOCK`` queries and each chunk of ``CE_CHUNK`` tokens of the head
recomputed in the backward pass (``torch.utils.checkpoint``).  ``q``
rounds values as ``reference.Quant`` does, for the control.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import Quant
from .models import rms_norm, ssd
from .train import unflatten_like

_PLAIN = Quant()
Q_BLOCK = 1024
CE_CHUNK = 2048
KINDS = {"M": "mamba", "E": "moe", "*": "attn_only"}
_KEY = {"mamba": "mamba", "attn_only": "attn", "moe": "moe"}


def pattern(m: dict) -> str:
    """The layer letters of the cut: the first ``num_hidden_layers``."""
    return m["hybrid_override_pattern"][:m["num_hidden_layers"]]


def _shapes(m: dict) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Each layer kind's weight shapes (leading axis of one) beside their
    fans (None: not drawn from the normal)."""
    D, V = m["hidden_size"], m["vocab_size"]
    H, P, N, G = m["mamba_num_heads"], m["mamba_head_dim"], \
        m["ssm_state_size"], m["n_groups"]
    din, conv = H * P, H * P + 2 * G * N
    Hq, K, hd = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    E, held, F_, Fs = m["model"]["router_experts"], m["n_routed_experts"], \
        m["moe_intermediate_size"], m["moe_shared_expert_intermediate_size"]
    return {
        "mamba": {"in_proj": ((1, D, 2 * din + 2 * G * N + H), D),
                  "conv_w": ((1, conv, m["conv_kernel"]), None),
                  "out_proj": ((1, din, D), din)},
        "attn_only": {"wq": ((1, D, Hq, hd), D), "wk": ((1, D, K, hd), D),
                      "wv": ((1, D, K, hd), D), "wo": ((1, Hq, hd, D),
                                                      Hq * hd)},
        "moe": {"router": ((1, D, E), D), "up": ((1, held, D, F_), D),
                "down": ((1, held, F_, D), F_), "shared_up": ((1, D, Fs), D),
                "shared_down": ((1, Fs, D), Fs)}}


def params(m: dict, gen: torch.Generator) -> dict:
    """The cut model's weights in the program's tree (``blocks/pos{i}``,
    a leading axis of one): embedding 0.02·N(0, 1), every projection,
    expert and the head He-normal (std √(2 / fan_in)), conv weights
    N(0, 1)/√d_conv, A_log = log U(1, 16), dt log-uniform in
    [time_step_min, time_step_max] and dt_bias = dt + log(−expm1(−dt)),
    D = 1; conv bias, norm scales and the correction bias 0.  One normal
    draw for every weight, one uniform draw for A_log and dt."""
    D, V, dev = m["hidden_size"], m["vocab_size"], gen.device
    kinds = [KINDS[c] for c in pattern(m)]
    shapes = _shapes(m)
    plan = [("embed", (V, D), None)] + [
        (f"{i}/{k}", s, fan) for i, kind in enumerate(kinds)
        for k, (s, fan) in shapes[kind].items()] + [("head", (D, V), D)]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in plan), generator=gen,
                       device=dev)
    drawn, at = {}, 0
    for name, shape, fan in plan:
        t = flat[at:at + math.prod(shape)].view(shape)
        at += t.numel()
        t.mul_(0.02 if name == "embed" else math.sqrt(2.0 / fan) if fan
               else 1.0 / math.sqrt(m["conv_kernel"]))
        drawn[name] = t
    H = m["mamba_num_heads"]
    n_m = kinds.count("mamba")
    u = torch.rand(2, n_m, H, generator=gen, device=dev)
    lo, hi = math.log(m["time_step_min"]), math.log(m["time_step_max"])
    dts = torch.exp(u[0] * (hi - lo) + lo)
    blocks, j = {}, 0

    def zeros(*shape):
        return torch.zeros((1,) + shape, device=dev)
    for i, kind in enumerate(kinds):
        w = {k: drawn[f"{i}/{k}"] for k in shapes[kind]}
        if kind == "mamba":
            dt = dts[j]
            w.update(conv_b=zeros(w["conv_w"].shape[1]),
                     A_log=torch.log(1.0 + 15.0 * u[1, j])[None],
                     dt_bias=(dt + torch.log(-torch.expm1(-dt)))[None],
                     D=torch.ones(1, H, device=dev),
                     norm=zeros(w["out_proj"].shape[1]))
            j += 1
        elif kind == "moe":
            w = {"router": w["router"],
                 "router_bias": zeros(w["router"].shape[-1]),
                 "up": w["up"], "down": w["down"],
                 "shared": {"up": w["shared_up"], "down": w["shared_down"]}}
        blocks[f"pos{i}"] = {"ln1": zeros(D), _KEY[kind]: w}
    return {"embed": drawn["embed"], "blocks": blocks,
            "final_norm": torch.zeros(D, device=dev), "head": drawn["head"]}


# ------------------------------------------------------------- mixers
def _strip(tree):
    return {k: _strip(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree[0]


def mamba(p: dict, u: torch.Tensor, m: dict, q: Quant) -> torch.Tensor:
    Bsz, S, _ = u.shape
    H, P, N, G = m["mamba_num_heads"], m["mamba_head_dim"], \
        m["ssm_state_size"], m["n_groups"]
    din, K, r = H * P, m["conv_kernel"], H // G
    z, xbc, dt = torch.split(q(q(u) @ q(p["in_proj"])),
                             [din, din + 2 * G * N, H], -1)
    conv = F.conv1d(q(xbc).transpose(1, 2), q(p["conv_w"])[:, None, :],
                    q(p["conv_b"]), padding=K - 1, groups=xbc.shape[-1])
    xs, Bm, Cm = torch.split(q(F.silu(conv[..., :S])).transpose(1, 2),
                             [din, G * N, G * N], -1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    X = xs.reshape(Bsz, S, H, P)
    Xdt, Adt = q(X * dt[..., None]), A * dt
    Bg, Cg = q(Bm).reshape(Bsz, S, G, N), q(Cm).reshape(Bsz, S, G, N)
    heads = [slice(g * r, (g + 1) * r) for g in range(G)]
    y = torch.cat([ssd(Xdt[:, :, hs], Adt[..., hs], Bg[:, :, g], Cg[:, :, g],
                       m["chunk_size"]) for g, hs in enumerate(heads)], dim=2)
    y = q(y) + X * p["D"][:, None]
    y = (y.reshape(Bsz, S, din) * F.silu(z)).reshape(Bsz, S, G, din // G)
    y = rms_norm(y, p["norm"].reshape(G, -1), m["norm_eps"])
    return q(q(y.reshape(Bsz, S, din)) @ q(p["out_proj"]))


def _attend(qb: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            start: int) -> torch.Tensor:
    """Queries qb (B, H, Qb, hd) at positions start.. over k, v (B, H, S,
    hd), causal."""
    s = qb @ k.transpose(-1, -2) / math.sqrt(qb.shape[-1])
    rows = torch.arange(start, start + qb.shape[2], device=qb.device)
    keep = rows[:, None] >= torch.arange(k.shape[2], device=qb.device)
    return torch.softmax(s.masked_fill(~keep, float("-inf")), -1) @ v


def attention(p: dict, u: torch.Tensor, m: dict, q: Quant) -> torch.Tensor:
    qh = torch.einsum("bsd,dhk->bhsk", q(u), q(p["wq"]))
    k = torch.einsum("bsd,dhk->bhsk", q(u), q(p["wk"]))
    v = torch.einsum("bsd,dhk->bhsk", q(u), q(p["wv"]))
    G = qh.shape[1] // k.shape[1]
    k, v = q(k).repeat_interleave(G, 1), q(v).repeat_interleave(G, 1)
    qh = q(qh)
    o = torch.cat([checkpoint(_attend, qh[:, :, s:s + Q_BLOCK], k, v, s,
                              use_reentrant=False)
                   for s in range(0, qh.shape[2], Q_BLOCK)], dim=2)
    return q(torch.einsum("bhsk,hkd->bsd", q(o), q(p["wo"])))


def _relu2(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           q: Quant) -> torch.Tensor:
    return q(q(torch.relu(q(q(x) @ q(up))).square()) @ q(down))


def moe(p: dict, u: torch.Tensor, m: dict, q: Quant) -> torch.Tensor:
    x = u.reshape(-1, u.shape[-1])
    s = torch.sigmoid(q(x) @ p["router"])
    _, chosen = torch.topk(s + p["router_bias"], m["num_experts_per_tok"],
                           dim=-1)
    w = s.gather(1, chosen)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]
    out = _relu2(x, p["shared"]["up"], p["shared"]["down"], q)
    for e in range(p["up"].shape[0]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if not rows.numel():
            continue
        out = out.index_add(0, rows, w[rows, slot, None]
                            * _relu2(x[rows], p["up"][e], p["down"][e], q))
    return out.reshape(u.shape)


MIXERS = {"mamba": mamba, "attn_only": attention, "moe": moe}


def _layer(p: dict, kind: str, x: torch.Tensor, m: dict,
           q: Quant) -> torch.Tensor:
    h = rms_norm(x, p["ln1"], m["norm_eps"])
    return q(x + MIXERS[kind](p[_KEY[kind]], h, m, q))


def hidden(tree: dict, tokens: torch.Tensor, m: dict,
           q: Quant = _PLAIN) -> torch.Tensor:
    """(B, S) ids → (B, S, D) final-normed hidden states, each layer
    recomputed in the backward pass."""
    x = q(tree["embed"][tokens.long()])
    for i, c in enumerate(pattern(m)):
        x = checkpoint(_layer, _strip(tree["blocks"][f"pos{i}"]), KINDS[c],
                       x, m, q, use_reentrant=False)
    return rms_norm(x, tree["final_norm"], m["norm_eps"])


def _ce_sum(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
            q: Quant) -> torch.Tensor:
    return F.cross_entropy(q(q(h) @ q(head)), labels.long(), reduction="sum")


def step_grads(params: Dict[str, torch.Tensor], like: dict,
               tokens: torch.Tensor, labels: torch.Tensor, m: dict,
               q: Quant = _PLAIN) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean token CE over the (B, S) batch and its gradient, a sequence at
    a time (each sequence's summed loss over B·S, the gradients added)."""
    total = tokens.numel()
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss_sum = 0.0
    for r in range(tokens.shape[0]):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        tree = unflatten_like(live, like)
        h = hidden(tree, tokens[r:r + 1], m, q)[0]
        loss = sum(checkpoint(_ce_sum, h[s:s + CE_CHUNK], tree["head"],
                              labels[r, s:s + CE_CHUNK], q,
                              use_reentrant=False)
                   for s in range(0, h.shape[0], CE_CHUNK)) / total
        got = torch.autograd.grad(loss, list(live.values()),
                                  materialize_grads=True)
        for k, g in zip(live, got):
            grads[k] += g
        loss_sum += float(loss.detach())
        del live, tree, h, loss, got
    return loss_sum, grads
