"""Plain forwards of the benchmark's two models, in float32.

The LEAF FEMNIST CNN (arXiv:2211.05739, Table I): NHWC images, HWIO
kernels, two 5x5 SAME convs with ReLU and a 2x2 max pool, the flatten in
NHWC order, FC + ReLU, FC.

The Mamba2 LM (arXiv:2405.21060), one group: embedding, then per layer
x + mixer(rmsnorm(x)), where the mixer is in_proj -> (z, x, B, C, dt),
a depthwise causal conv and SiLU on (x, B, C), dt = softplus(dt + bias),
A = -exp(A_log), the SSD scan in its chunked form (``ssd``, the minimal
algorithm of the paper's listing), y + D·x, the gated RMSNorm
rmsnorm(y·silu(z)) and out_proj; a final RMSNorm and the tied head.
RMSNorm scales by (1 + w).  Params keep the program's tree: the layers
stacked on a leading axis under ``blocks/pos0``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import Quant

_PLAIN = Quant()


# ------------------------------------------------------------- the CNN
def cnn_forward(params: dict, x: torch.Tensor, q: Quant = _PLAIN
                ) -> torch.Tensor:
    """(B, H, W, C) float32 images -> (B, classes) logits."""
    h = q(x).permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        w = q(params[name]["w"]).permute(3, 2, 0, 1)       # HWIO -> OIHW
        h = F.conv2d(h, w, q(params[name]["b"]),
                     padding=(w.shape[2] // 2, w.shape[3] // 2))
        h = q(F.max_pool2d(F.relu(h), 2))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = q(F.relu(h @ q(params["fc1"]["w"]) + q(params["fc1"]["b"])))
    return q(h @ q(params["out"]["w"]) + q(params["out"]["b"]))


# ------------------------------------------------------------- the LM
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of a over (j, i] where i >= j, -inf
    above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd(X: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """Chunked SSD from a zero state.  X (b, l, h, p) already scaled by
    dt, A (b, l, h) = A·dt, B and C (b, l, n) shared by the heads."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence {l} is not a multiple of chunk {chunk}")
    c = l // chunk
    X = X.reshape(b, c, chunk, h, p)
    B = B.reshape(b, c, chunk, n)
    C = C.reshape(b, c, chunk, n)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b,h,c,q)
    A_cum = torch.cumsum(A, dim=-1)
    # within each chunk: (C·Bᵀ ∘ L)·X
    L = torch.exp(_segsum(A))                                  # (b,h,c,q,q)
    CB = torch.einsum("bcln,bcsn->bcls", C, B)
    Y = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, X)
    # each chunk's state, carried across chunks
    decay = torch.exp(A_cum[..., -1:] - A_cum)                 # (b,h,c,q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    ends = F.pad(A_cum[..., -1], (1, 0))                       # (b,h,c+1)
    carry = torch.exp(_segsum(ends))                           # (b,h,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    Y = Y + torch.einsum("bcln,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cum))
    return Y.reshape(b, l, h, p)


def _mixer(p: dict, i: int, u: torch.Tensor, m: dict, q: Quant
           ) -> torch.Tensor:
    d_inner, H, N, K = m["d_inner"], m["nheads"], \
        m["ssm_cfg"]["d_state"], m["ssm_cfg"]["d_conv"]
    P = m["ssm_cfg"]["headdim"]
    Bsz, S, _ = u.shape
    proj = q(q(u) @ q(p["in_proj"][i]))
    z, xs, Bm, Cm, dt = torch.split(proj, [d_inner, d_inner, N, N, H], -1)
    xbc = torch.cat([xs, Bm, Cm], dim=-1).transpose(1, 2)      # (B, C, S)
    conv = F.conv1d(q(xbc), q(p["conv_w"][i])[:, None, :],
                    q(p["conv_b"][i]), padding=K - 1,
                    groups=xbc.shape[1])[..., :S]
    xs, Bm, Cm = torch.split(q(F.silu(conv)).transpose(1, 2),
                             [d_inner, N, N], -1)
    dt = F.softplus(dt + p["dt_bias"][i])                      # (B, S, H)
    A = -torch.exp(p["A_log"][i])
    X = xs.reshape(Bsz, S, H, P)
    y = ssd(q(X * dt[..., None]), A * dt, q(Bm), q(Cm), m["chunk_size"])
    y = q(y) + X * p["D"][i][:, None]
    y = rms_norm(y.reshape(Bsz, S, d_inner) * F.silu(z), p["norm"][i],
                 m["norm_epsilon"])
    return q(q(y) @ q(p["out_proj"][i]))


def lm_hidden(params: dict, tokens: torch.Tensor, m: dict,
              q: Quant = _PLAIN) -> torch.Tensor:
    """(B, S) ids -> (B, S, D) final-normed hidden states."""
    blocks = params["blocks"]["pos0"]
    x = q(params["embed"][tokens.long()])
    for i in range(m["n_layer"]):
        h = rms_norm(x, blocks["ln1"][i], m["norm_epsilon"])
        x = q(x + _mixer(blocks["mamba"], i, h, m, q))
    return rms_norm(x, params["final_norm"], m["norm_epsilon"])


def lm_logits(params: dict, h: torch.Tensor, q: Quant = _PLAIN
              ) -> torch.Tensor:
    """Tied head: h (..., D) -> (..., V) float32 logits."""
    return q(q(h) @ q(params["embed"]).t())
