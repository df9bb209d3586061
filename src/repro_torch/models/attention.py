"""GQA attention: full/sliding-window causal (prefill), cross attention
(VLM), and single-token decode against a KV cache.  The port of the JAX
package's models/attention.py.

Layouts (head dims kept explicit, as in the reference):
  wq: (D, H, hd)   wk/wv: (D, K, hd)   wo: (H, hd, D)
  KV cache: (B, K, S_cache, hd); window layers use a ring buffer.

With ``sdpa`` (the port's ``attn_only`` blocks, Nemotron-H's layers,
trained at 8192 positions) full-sequence causal self-attention runs in
torch's ``scaled_dot_product_attention``, whose backward the port's
``flash_attention`` kernel lacks.
With ``cfg.use_pallas_attention`` full-sequence self-attention runs in the
hand-written ``flash_attention`` kernel (the reference's field name: in
the port it routes to the CUDA kernel, and to its plain version on the
CPU).  The decode cache is updated in place (an indexed write at each
row's slot), where the reference builds a new array.

On DTensors (the sharded train step) a block runs head-parallel in a
``local_map`` region (``_attention_sharded``): the specs' layout, heads
over the model axis and batch over the data axes, computed directly.
DTensor could place the block op by op, but it re-lays tensors out
between ops (about a hundred collectives a layer a step), and the GQA
einsums flatten a batch dim sharded over data with a head dim sharded
over model, whose strided layouts cost seconds a call to plan; the
region's collectives are the weights' gathers over the data axes and one
all-reduce of the output over the model axis (their grads: the
reductions back, and one all-reduce of x's grad).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels.flash_attention import flash_attention
from ..sharding.spmd import (act_in, batch_placements, model_shard, region,
                             weight_in)
from .config import ArchConfig
from .layers import apply_rope, he_init, softcap

Pytree = Any

NEG_INF = -2.3819763e38  # large negative for masking in fp32


def attn_init(gen: torch.Generator, cfg: ArchConfig,
              dtype=torch.float32) -> Pytree:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": he_init(gen, (D, H, hd), D, dtype),
            "wk": he_init(gen, (D, K, hd), D, dtype),
            "wv": he_init(gen, (D, K, hd), D, dtype),
            "wo": he_init(gen, (H, hd, D), H * hd, dtype)}


def _qkv(p: Pytree, x: torch.Tensor,
         src: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Queries of x (B, S, D); keys and values of ``src`` (x if None)."""
    src = x if src is None else src
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(x.dtype))
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,K,hd) → scores (B,K,G,Sq,Sk), G=H/K."""
    B, Sq, H, hd = q.shape
    qg = q.reshape(B, Sq, n_kv, H // n_kv, hd)
    scale = torch.sqrt(torch.tensor(float(hd))).to(q.dtype)
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) / scale


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,K,G,Sq,Sk), v: (B,Sk,K,hd) → (B,Sq,H,hd)."""
    B, K, G, Sq, _ = probs.shape
    o = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return o.reshape(B, Sq, K * G, v.shape[-1])


def _causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) boolean mask: True = attend."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _softmax(scores: torch.Tensor, mask: torch.Tensor,
             cap: float, fp32: bool = True) -> torch.Tensor:
    if fp32:
        s = softcap(scores.float(), cap)
        s = torch.where(mask, s, NEG_INF)
        return torch.softmax(s, dim=-1)
    # bf16 softmax path: halves the (B,K,G,Sq,Sk) tensor traffic;
    # max-subtraction keeps it stable, mask value fits bf16 range
    s = softcap(scores, cap)
    s = torch.where(mask, s, -3e38)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _attention_sharded(p: Pytree, x, src, rope, core):
    """The attention block of DTensor ``x`` (B, S, D) (its keys and values
    projected from ``src``: x itself, or a VLM's image features) as a
    ``local_map`` region: batch over the data axes, heads over the model
    axis.  The query heads split when they divide the axis, the KV heads
    with them when those divide it too; else each rank projects every KV
    head and keeps those its query heads read.  Query heads that do not
    divide the axis run whole on every rank.  Inside: ``_qkv``, ``rope``,
    ``core(q, k, v)`` on the local heads, the output projection; each
    rank's output is its heads' part, all-reduced over the model axis."""
    rank, size = model_shard(x.device_mesh)
    H, K = p["wq"].shape[1], p["wk"].shape[1]
    q_split = H % size == 0
    kv_split = q_split and K % size == 0
    q_on = Shard(1) if q_split else Replicate()
    kv_on = Shard(1) if kv_split else Replicate()

    def local(x_l, s_l, wq, wk, wv, wo):
        q, k, v = _qkv({"wq": wq, "wk": wk, "wv": wv}, x_l, s_l)
        q, k = rope(q), rope(k)
        if q_split and not kv_split:
            n = q.shape[2]
            heads = (rank * n + torch.arange(n, device=q.device)) // (H // K)
            k, v = k[:, :, heads], v[:, :, heads]
        return torch.einsum("bshk,hkd->bsd", core(q, k, v),
                            wo.to(x_l.dtype))

    out = region(local, [act_in(x), act_in(src), weight_in(p["wq"], q_on),
                         weight_in(p["wk"], kv_on), weight_in(p["wv"], kv_on),
                         weight_in(p["wo"], Shard(0) if q_split
                                   else Replicate())],
                 Partial() if q_split else Replicate())
    return out.redistribute(placements=batch_placements(x))


# --------------------------------------------------------------- full seq
def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor, cfg: ArchConfig,
                      window: Optional[int], q_chunk: int) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention of q (B, S, H, hd) over
    k, v (B, S, K, hd) at positions ``pos`` (S,), in chunks of ``q_chunk``
    queries past that length."""
    S = q.shape[1]
    n_kv = k.shape[2]
    if S <= q_chunk:
        mask = _causal_window_mask(pos, pos, window)
        probs = _softmax(_gqa_scores(q, k, n_kv), mask,
                         cfg.attn_logit_softcap,
                         cfg.attn_fp32_softmax).to(q.dtype)
        return _gqa_out(probs, v)
    assert S % q_chunk == 0, f"seq {S} not divisible by q_chunk {q_chunk}"
    outs = []
    for start in range(0, S, q_chunk):
        mask = _causal_window_mask(pos[start:start + q_chunk], pos, window)
        pr = _softmax(_gqa_scores(q[:, start:start + q_chunk], k, n_kv),
                      mask, cfg.attn_logit_softcap,
                      cfg.attn_fp32_softmax).to(q.dtype)
        outs.append(_gqa_out(pr, v))
    return torch.cat(outs, dim=1)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          cfg: ArchConfig, window: Optional[int]) -> torch.Tensor:
    """Causal GQA attention of q (B, S, H, hd) over k, v (B, S, K, hd) in
    torch's ``scaled_dot_product_attention`` (scale 1/√hd), each KV head
    repeated for its H / K query heads: its flash and memory-efficient
    backends keep memory linear in S under autograd, where the plain path
    saves every chunk's probabilities.  No window, no softcap."""
    if window or cfg.attn_logit_softcap:
        raise ValueError(f"{cfg.name}: SDPA attention takes no window and "
                         f"no softcap")
    G = q.shape[2] // k.shape[2]
    o = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
        v.repeat_interleave(G, dim=2).transpose(1, 2), is_causal=True)
    return o.transpose(1, 2)


def self_attention(p: Pytree, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ArchConfig, window: Optional[int] = None,
                   q_chunk: int = 1024, return_kv: bool = False,
                   sdpa: bool = False):
    """Causal (optionally windowed) self-attention over a full sequence.

    With ``cfg.use_pallas_attention`` it runs in the flash_attention
    kernel; otherwise long sequences take the query dimension in chunks,
    so live buffers stay O(q_chunk · S) instead of O(S²).
    """
    def rope(t):
        return apply_rope(t, positions, cfg.rope_fraction, cfg.rope_theta)

    def core(q, k, v):
        if sdpa:
            return _sdpa(q, k, v, cfg, window)
        if cfg.use_pallas_attention:
            # (B,S,H,hd) views as (B,H,S,hd): the kernel reads them in place
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window,
                                softcap=cfg.attn_logit_softcap)
            return o.transpose(1, 2).to(q.dtype)
        return _causal_attention(q, k, v, positions[0], cfg, window, q_chunk)

    if isinstance(x, DTensor):
        if return_kv:
            raise ValueError("return_kv (prefill) takes plain tensors")
        # the region sees its rows of the batch, whose positions are all
        # the same (0..S-1, transformer._positions): the first row's serve
        positions = positions[:1]
        return _attention_sharded(p, x, x, rope, core)
    q, k, v = _qkv(p, x)
    q, k = rope(q), rope(k)
    out = torch.einsum("bshk,hkd->bsd", core(q, k, v), p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


def kv_to_cache(k: torch.Tensor, v: torch.Tensor, window: Optional[int],
                dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Convert prefill (B, S, K, hd) roped keys/values into the decode
    cache layout (B, K, S_cache, hd).  Window layers keep the last
    `window` entries arranged by ring-buffer slot (t % window) so decode
    can continue writing at position S."""
    B, S, K, hd = k.shape
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if window and S > window:
        slots = torch.arange(window, device=k.device)
        # slot i holds the largest t < S with t % window == i
        t = (S - 1) - torch.remainder(S - 1 - slots, window)
        kt = kt[:, :, t, :]
        vt = vt[:, :, t, :]
    elif window and S <= window:
        pad = window - S
        kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
    return (kt.to(dtype).contiguous(), vt.to(dtype).contiguous())


# --------------------------------------------------------------- cross
def _cross_core(q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """Queries (B, S, H, hd) over keys and values (B, P, K, hd), unmasked,
    the softmax in fp32."""
    scores = _gqa_scores(q, k, k.shape[2])
    return _gqa_out(torch.softmax(scores.float(), dim=-1).to(q.dtype), v)


def _cross(p: Pytree, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """Text queries of x (B, S, D) over the vision keys and values
    (B, P, K, hd), unmasked, the softmax in fp32."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    return torch.einsum("bshk,hkd->bsd", _cross_core(q, k, v),
                        p["wo"].to(x.dtype))


def cross_attention(p: Pytree, x: torch.Tensor, kv_feats: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    """Text queries attend over (unmasked) vision features (B, P, D)."""
    if isinstance(x, DTensor):
        return _attention_sharded(p, x, kv_feats, lambda t: t, _cross_core)
    k = torch.einsum("bpd,dhk->bphk", kv_feats, p["wk"].to(x.dtype))
    v = torch.einsum("bpd,dhk->bphk", kv_feats, p["wv"].to(x.dtype))
    return _cross(p, x, k, v, cfg)


def init_cross_cache(p: Pytree, kv_feats: torch.Tensor,
                     dtype=torch.bfloat16) -> Pytree:
    """Precompute cross-attention K/V (B, P, K, hd) from vision features
    once."""
    k = torch.einsum("bpd,dhk->bphk", kv_feats, p["wk"].to(kv_feats.dtype))
    v = torch.einsum("bpd,dhk->bphk", kv_feats, p["wv"].to(kv_feats.dtype))
    return {"ck": k.to(dtype), "cv": v.to(dtype)}


def decode_cross_attention(p: Pytree, x: torch.Tensor, cross_cache: Pytree,
                           cfg: ArchConfig) -> torch.Tensor:
    return _cross(p, x, cross_cache["ck"].to(x.dtype),
                  cross_cache["cv"].to(x.dtype), cfg)


# --------------------------------------------------------------- decode
def init_kv_cache(cfg: ArchConfig, batch: int, length: int,
                  dtype=torch.bfloat16, device=None) -> Pytree:
    K, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, K, length, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, K, length, hd), dtype=dtype,
                             device=device)}


def decode_self_attention(p: Pytree, x: torch.Tensor, cache: Pytree,
                          pos: torch.Tensor, cfg: ArchConfig,
                          window: Optional[int] = None
                          ) -> Tuple[torch.Tensor, Pytree]:
    """One-token decode. x: (B, 1, D); pos: (B,) current positions.

    Full-attention layers use a cache of the full context; window layers a
    ring buffer of size `window` (keys are roped at absolute positions
    before caching, so the ring wrap is transparent).  The cache tensors
    are written in place and returned.
    """
    S_cache = cache["k"].shape[2]
    q, k_new, v_new = _qkv(p, x)
    q = apply_rope(q, pos[:, None], cfg.rope_fraction, cfg.rope_theta)
    k_new = apply_rope(k_new, pos[:, None], cfg.rope_fraction,
                       cfg.rope_theta)

    slot = (torch.remainder(pos, S_cache) if window
            else torch.clamp(pos, max=S_cache - 1))
    k_cache = _scatter_time(cache["k"], k_new.to(cache["k"].dtype), slot)
    v_cache = _scatter_time(cache["v"], v_new.to(cache["v"].dtype), slot)

    scores = _gqa_scores(q, k_cache.transpose(1, 2).to(x.dtype),
                         cfg.n_kv_heads)                     # (B,K,G,1,S)
    idx = torch.arange(S_cache, device=x.device)
    if window:
        # ring buffer: a slot is valid if written within the last `window`
        # steps, i.e. slot index corresponds to some t in (pos-window, pos]
        valid = _ring_valid(idx, pos, S_cache)               # (B, S)
    else:
        valid = idx[None, :] <= pos[:, None]
    mask = valid[:, None, None, None, :]
    s = softcap(scores.float(), cfg.attn_logit_softcap)
    s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    o = _gqa_out(probs, v_cache.transpose(1, 2).to(x.dtype))
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, {"k": k_cache, "v": v_cache}


def _scatter_time(cache: torch.Tensor, new: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """cache (B,K,S,hd) ← new (B,1,K,hd) at per-row time index slot (B,),
    written in place (the reference's one-hot blend, exact for finite
    caches, without a pass over the whole cache)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, :, slot, :] = new[:, 0]
    return cache


def _ring_valid(idx: torch.Tensor, pos: torch.Tensor, S: int) -> torch.Tensor:
    """Valid slots of a ring buffer of size S after writing position pos."""
    # slot i currently holds time t(i) = the largest t ≤ pos with t % S == i;
    # a floor modulo, as JAX's %, for the negative differences
    p = pos[:, None]
    t = p - torch.remainder(p - idx[None, :], S)
    return (t >= 0) & (t >= p - S + 1)
