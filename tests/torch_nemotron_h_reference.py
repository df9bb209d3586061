"""A plain reference of Nemotron-H (NVIDIA Nemotron 3 Nano 30B-A3B) for
the port's tests: plain ``torch`` in float32, nothing of ``repro_torch``,
no kernel, written from the layer equations.

Per layer, x + mixer(rmsnorm(x)), the mixer one of
  M  Mamba2: in_proj → (z, xBC, dt); xBC through a depthwise causal conv
     with bias and SiLU, split into x, B, C (B and C in G groups of n);
     dt = softplus(dt + dt_bias), A = −exp(A_log); the SSM recurrence
     h ← exp(A·dt)·h + dt·x ⊗ B, y = h·C, head i reading group
     i // (H / G), run position by position; y + D·x; RMSNorm of
     y·silu(z) per group of d_inner / G channels; out_proj;
  *  attention: q, k, v, o without bias, each KV head shared by H / K
     query heads, causal softmax of q·kᵀ/√hd, no positional encoding;
  E  MoE: logits x·W, s = sigmoid(logits), the top k of s + bias chosen,
     weights s / Σs × scale; each chosen expert's down(relu(up(x))²) by
     its weight, summed, plus the shared expert's down(relu(up(x))²);
then a final RMSNorm and the untied head.  Params are the port's tree
(each layer under ``blocks/pos{i}`` with a leading axis of one).

Departures from the published modelling code (transformers'
``modeling_nemotron_h``), none of which changes the function:
- RMSNorm scales by (1 + w) with w stored from zero, where the published
  code stores the scale itself from one;
- the router's correction bias is a parameter of the tree (its gradient
  is zero: it only steers the choice), where the published code keeps a
  buffer;
- the MoE layer here holds experts ``first`` .. ``first + held − 1`` of the
  router's E: the routed sum over those alone (what one card of an
  expert-parallel layer computes), the shared expert added by
  ``shared=True``;
- everything runs in float32, where the published model runs bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def mamba(p, u, cfg):
    """The Mamba2 mixer of u (B, S, D)."""
    Bsz, S, _ = u.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    din = H * P
    z, xbc, dt = torch.split(u @ p["in_proj"], [din, din + 2 * G * N, H], -1)
    K = p["conv_w"].shape[1]
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"][:, None, :],
                    p["conv_b"], padding=K - 1, groups=xbc.shape[-1])
    xbc = F.silu(conv[..., :S]).transpose(1, 2)
    x, Bm, Cm = torch.split(xbc, [din, G * N, G * N], -1)
    dt = F.softplus(dt + p["dt_bias"])                         # (B, S, H)
    A = -torch.exp(p["A_log"])
    x = x.reshape(Bsz, S, H, P)
    group = torch.arange(H) // (H // G)
    Bh = Bm.reshape(Bsz, S, G, N)[:, :, group]                 # (B, S, H, N)
    Ch = Cm.reshape(Bsz, S, G, N)[:, :, group]
    h = torch.zeros(Bsz, H, P, N)
    ys = []
    for t in range(S):
        h = (torch.exp(A * dt[:, t])[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, 1) + x * p["D"][:, None]
    y = (y.reshape(Bsz, S, din) * F.silu(z)).reshape(Bsz, S, G, din // G)
    y = rms_norm(y, p["norm"].reshape(G, -1), cfg.norm_eps)
    return y.reshape(Bsz, S, din) @ p["out_proj"]


def attention(p, u, cfg):
    """Causal GQA attention of u (B, S, D), no positional encoding."""
    S = u.shape[1]
    q = torch.einsum("bsd,dhk->bhsk", u, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", u, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", u, p["wv"])
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                      float("-inf"))
    o = torch.softmax(s, -1) @ v                               # (B, H, S, hd)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


def relu2_mlp(x, up, down):
    return torch.relu(x @ up).square() @ down


def moe(p, u, cfg, first=0, shared=True):
    """The MoE mixer of u (B, S, D): experts ``first`` .. on (as many as
    ``p["up"]`` holds) of the router's, each on every token times its
    routing weight (zero where it is not chosen)."""
    x = u.reshape(-1, u.shape[-1])
    s = torch.sigmoid(x @ p["router"])
    _, chosen = torch.topk(s + p["router_bias"], cfg.top_k, dim=-1)
    w = s.gather(1, chosen)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale
    out = torch.zeros_like(x)
    for e in range(p["up"].shape[0]):
        weight = (w * (chosen == first + e)).sum(-1, keepdim=True)
        out = out + weight * relu2_mlp(x, p["up"][e], p["down"][e])
    if shared:
        out = out + relu2_mlp(x, p["shared"]["up"], p["shared"]["down"])
    return out.reshape(u.shape)


MIXERS = {"mamba": mamba, "attn_only": attention, "moe": moe}


def logits(params, tokens, cfg):
    """(B, S) ids → (B, S, V) logits."""
    x = params["embed"][tokens]
    for i, kind in enumerate(cfg.pattern):
        p = _layer(params, i)
        x = x + MIXERS[kind](p[_KEY[kind]], rms_norm(x, p["ln1"],
                                                     cfg.norm_eps), cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps) @ params["head"]


def loss(params, tokens, labels, cfg):
    lg = logits(params, tokens, cfg)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


_KEY = {"mamba": "mamba", "attn_only": "attn", "moe": "moe"}


def _layer(params, i):
    """Layer i's params without the leading axis of one."""
    def strip(t):
        return {k: strip(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return strip(params["blocks"][f"pos{i}"])
