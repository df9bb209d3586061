"""Mamba2 block: SSD (state-space duality) with a chunked scan.

The port of the JAX package's models/ssm.py (Dao & Gu 2024,
arXiv:2405.21060): scalar-per-head A, depthwise causal conv on (x, B, C),
softplus dt, gated RMSNorm.  With ``cfg.ssm_groups`` = G > 1 (Nemotron-H:
64 heads in 8 groups) B and C come in G groups of ``ssm_state`` (head h
reads group h // (H / G)), are handed to the scan as (b, l, G, n) tensors
that it reads in place, and the gated RMSNorm runs per group of
d_inner / G channels (Nemotron-H's ``MambaRMSNormGated``); the head count
may be set apart from ``expand`` (``cfg.ssm_n_heads``).  One group keeps
the head-broadcast views and the whole-width norm.  Decode takes one
group only.  The full-sequence block runs the scan in the
hand-written ``ssd_scan`` kernel (its plain version on the CPU), which
also hands back the final state for the decode cache.  Decode is the O(1)
recurrence in plain PyTorch
  h ← exp(A·dt)·h + dt·B⊗x ;  y = C·h + D·x,
and writes the cache tensors in place, where the reference builds new ones.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from ..kernels.ssd_scan import ssd_scan, ssd_scan_plain, ssd_scan_sharded
from ..sharding.spmd import act_in, region, weight_in
from .config import ArchConfig
from .layers import he_init, rms_norm

Pytree = Any


def _dims(cfg: ArchConfig):
    """(d_inner, heads, head dim, state, conv width, in_proj width); B
    and C are G·state wide for G groups."""
    d_inner = cfg.d_inner
    H = cfg.ssm_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    GN = cfg.ssm_groups * N
    conv_dim = d_inner + 2 * GN          # conv over (x, B, C)
    d_in_proj = 2 * d_inner + 2 * GN + H  # z, x, B, C, dt
    return d_inner, H, P, N, conv_dim, d_in_proj


def _uniform(gen: torch.Generator, shape, low: float = 0.0,
             high: float = 1.0) -> torch.Tensor:
    return low + (high - low) * torch.rand(tuple(shape), generator=gen,
                                           device=gen.device)


def mamba_init(gen: torch.Generator, cfg: ArchConfig,
               dtype=torch.float32) -> Pytree:
    """Random block params from ``gen`` with the reference's keys, shapes,
    dtypes and spreads (A_log, dt_bias and D stay fp32)."""
    D = cfg.d_model
    d_inner, H, P, N, conv_dim, d_in_proj = _dims(cfg)
    dev = gen.device
    dt = torch.exp(_uniform(gen, (H,)) * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    conv_w = torch.randn((conv_dim, cfg.ssm_conv), generator=gen, device=dev)
    return {
        "in_proj": he_init(gen, (D, d_in_proj), D, dtype),
        "conv_w": (conv_w * (1.0 / math.sqrt(cfg.ssm_conv))).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(_uniform(gen, (H,), 1.0, 16.0)),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": he_init(gen, (d_inner, D), d_inner, dtype),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    d_inner, H, P, N, _, _ = _dims(cfg)
    GN = cfg.ssm_groups * N
    return torch.split(proj, [d_inner, d_inner, GN, GN, H], dim=-1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """rmsnorm(y·silu(z)) over the whole width (one group) or per group
    of d_inner / G channels."""
    G = cfg.ssm_groups
    if G == 1:
        return rms_norm(y * F.silu(z), scale, cfg.norm_eps)
    shape = y.shape
    yg = (y * F.silu(z)).reshape(*shape[:-1], G, shape[-1] // G)
    return rms_norm(yg, scale.reshape(G, -1), cfg.norm_eps).reshape(shape)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)), as ``jax.nn.softplus`` computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-d conv. xbc: (B, S, C); w: (C, K).  On DTensors
    a ``local_map`` region over each rank's rows of the batch, the weights
    whole: some PyTorch releases place the padding of a tensor on a 2-d
    mesh with one placement too few."""
    if isinstance(xbc, DTensor):
        return region(_causal_conv, [act_in(xbc), weight_in(w), weight_in(b)],
                      Replicate())
    K = w.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    y = _conv_unrolled(pad, w, K)
    return F.silu(y + b.to(y.dtype))


def _conv_unrolled(padded: torch.Tensor, w: torch.Tensor,
                   K: int) -> torch.Tensor:
    """Small-K depthwise conv as a sum of shifted slices (K ≤ 4)."""
    S = padded.shape[1] - (K - 1)
    acc = None
    for i in range(K):
        term = padded[:, i:i + S, :] * w[:, i].to(padded.dtype)
        acc = term if acc is None else acc + term
    return acc


def ssd_chunked(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan: the reference's signature, computed by the
    kernel's plain version in fp32 from ``init_state`` (zero when None).

    x (b,l,h,p) — already scaled by dt;  a_dt (b,l,h) = A·dt;
    B, C (b,l,h,n).  Returns (y (b,l,h,p), final_state (b,h,p,n) fp32).
    """
    if x.shape[1] % chunk:
        raise ValueError(f"seq {x.shape[1]} not divisible by chunk {chunk}")
    return ssd_scan_plain(x, a_dt, B, C, chunk, return_state=True,
                          init_state=init_state)


def mamba_block(p: Pytree, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 128, return_cache: bool = False):
    """Full-sequence Mamba2 block. x: (B, S, D) → (B, S, D); with
    ``return_cache`` also the decode cache {"conv", "ssm"} in fp32."""
    Bsz, S, D = x.shape
    d_inner, H, P, N, conv_dim, _ = _dims(cfg)
    proj = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)

    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    G = cfg.ssm_groups
    xs, Bm, Cm = torch.split(xbc, [d_inner, G * N, G * N], dim=-1)

    dt = _softplus(dt_raw.float() + p["dt_bias"])               # (B,S,H)
    A = -torch.exp(p["A_log"])                                  # (H,)
    xh = xs.reshape(Bsz, S, H, P)
    if G == 1:
        # head-broadcast views (head stride 0): the kernel reads them in
        # place
        Bh = Bm[:, :, None, :].expand(Bsz, S, H, N).to(x.dtype)
        Ch = Cm[:, :, None, :].expand(Bsz, S, H, N).to(x.dtype)
    else:
        # (B, S, G, N) groups, read in place too
        Bh = Bm.reshape(Bsz, S, G, N).to(x.dtype)
        Ch = Cm.reshape(Bsz, S, G, N).to(x.dtype)

    ck = min(chunk, S)
    while S % ck:
        ck -= 1
    # DTensors (the sharded train step) scan in a local_map region
    scan = ssd_scan_sharded if isinstance(xh, DTensor) else ssd_scan
    y, final_state = scan(xh * dt[..., None].to(x.dtype),
                              A[None, None, :] * dt, Bh, Ch, chunk=ck,
                              return_state=True)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(Bsz, S, d_inner), z, p["norm"], cfg)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if return_cache:
        K = cfg.ssm_conv
        tail = xbc_raw[:, -(K - 1):, :]
        if S < K - 1:
            tail = F.pad(xbc_raw, (0, 0, K - 1 - S, 0))
        cache = {"conv": tail.to(torch.float32, copy=True),
                 "ssm": final_state}
        return out, cache
    return out


# ----------------------------------------------------------------- decode
def init_mamba_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Pytree:
    d_inner, H, P, N, conv_dim, _ = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, H, P, N), dtype=dtype, device=device)}


def mamba_decode_step(p: Pytree, x: torch.Tensor, cache: Pytree,
                      cfg: ArchConfig) -> Tuple[torch.Tensor, Pytree]:
    """One-token decode. x: (B, 1, D), one B/C group.  The cache's tensors
    are updated in place; the same tree is returned."""
    if cfg.ssm_groups != 1:
        raise ValueError(f"{cfg.name}: Mamba2 decode takes one B/C group, "
                         f"not {cfg.ssm_groups}")
    Bsz = x.shape[0]
    d_inner, H, P, N, conv_dim, _ = _dims(cfg)
    proj = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))[:, 0]
    z, xs, Bm, Cm, dt_raw = _split_proj(cfg, proj)

    xbc_new = torch.cat([xs, Bm, Cm], dim=-1)                  # (B, conv_dim)
    window = torch.cat([cache["conv"].to(x.dtype), xbc_new[:, None, :]],
                       dim=1)
    w = p["conv_w"].to(x.dtype)                                # (C, K)
    y_conv = torch.einsum("bkc,ck->bc", window, w) + p["conv_b"].to(x.dtype)
    xbc = F.silu(y_conv)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = _softplus(dt_raw.float() + p["dt_bias"])              # (B,H)
    A = -torch.exp(p["A_log"])
    a = torch.exp(A[None, :] * dt)                             # (B,H)
    xh = xs.reshape(Bsz, H, P)
    h_prev = cache["ssm"].float()
    dBx = (dt[..., None, None] * Bm.float()[:, None, None, :]
           * xh.float()[..., None])                            # (B,H,P,N)
    h = a[..., None, None] * h_prev + dBx
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float())
    y = y.to(x.dtype) + xh * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(Bsz, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("be,ed->bd", y, p["out_proj"].to(x.dtype))
    cache["conv"].copy_(window[:, 1:, :])
    cache["ssm"].copy_(h)
    return out[:, None, :], cache
