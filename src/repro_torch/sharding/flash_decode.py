"""Flash decoding over a sequence-sharded KV cache.

The port of the JAX package's sharding/flash_decode.py.  Each slab of the
cache's sequence dim computes a partial softmax over its keys (local max,
local sum of exponentials, exp-weighted values), and the slabs combine
with a max and two sums of (B, H, hd)-sized partials: the cache itself is
never gathered.  The reference's ``shard_map`` with ``pmax``/``psum``
becomes a loop over the port's single-process ``launch.mesh.Mesh``: the
slabs' partials run on their devices and combine on the mesh's first
device, as the sharded merge's sums do.  Nothing on the serve path calls
it, as in the reference.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

NEG = -1e30


def _scale(hd: int, dtype) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(hd))).to(dtype)


def _partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local partial softmax over one slab of the KV cache.

    q: (B, K, G, hd); k/v: (B, K, S_loc, hd); valid: (B, S_loc) bool.
    Returns (o_partial (B,K,G,hd) — exp-weighted values, m (B,K,G),
    l (B,K,G) — local sum-exp)."""
    s = torch.einsum("bkgh,bksh->bkgs", q, k) / _scale(q.shape[-1], q.dtype)
    mask = valid[:, None, None, :]
    s = torch.where(mask, s.float(), NEG)
    m = s.amax(dim=-1)                                       # (B,K,G)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p.to(v.dtype), v)
    return o.float(), m, l


def _coords(mesh):
    """Each device of ``mesh`` with its index along every axis (row-major,
    the device order of ``Mesh``)."""
    names = list(mesh.shape)
    for dev, idx in zip(mesh.devices, itertools.product(
            *(range(mesh.shape[n]) for n in names))):
        yield dev, dict(zip(names, idx))


def sharded_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, pos: torch.Tensor,
                             mesh, seq_axis: str = "model",
                             batch_axis: Optional[str] = "data"
                             ) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, K, S, hd) with S split over
    ``seq_axis``; pos: (B,) current positions.  → (B, H, hd) on the mesh's
    first device.

    Each slab holds S/n contiguous slots; validity comes from the global
    slot index (linear cache layout: slot t ≤ pos is valid).  B splits
    over ``batch_axis`` when the mesh has it and it divides B; the other
    axes hold replicas, of which the first computes.
    """
    B, H, hd = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    if seq_axis not in mesh.shape:
        raise ValueError(f"the mesh {mesh} has no axis {seq_axis!r}")
    n_shards = mesh.shape[seq_axis]
    if S % n_shards:
        raise ValueError(f"a cache of {S} slots does not split over "
                         f"{n_shards} devices")
    s_loc = S // n_shards
    n_b = mesh.shape.get(batch_axis, 1) if batch_axis else 1
    if B % n_b:
        n_b = 1
    b_loc = B // n_b
    home = mesh.devices[0]
    qg = q.reshape(B, K, G, hd)

    slabs = {}                            # (batch part, seq part) → device
    for dev, idx in _coords(mesh):
        key = (idx[batch_axis] if n_b > 1 else 0, idx[seq_axis])
        slabs.setdefault(key, dev)
    out = []
    for b in range(n_b):
        rows = slice(b * b_loc, (b + 1) * b_loc)
        parts = []
        for s in range(n_shards):
            dev = slabs[(b, s)]
            cols = slice(s * s_loc, (s + 1) * s_loc)
            idx = torch.arange(s * s_loc, (s + 1) * s_loc, device=dev)
            valid = idx[None, :] <= pos[rows].to(dev)[:, None]
            parts.append([t.to(home) for t in _partial_attention(
                qg[rows].to(dev), k_cache[rows, :, cols].to(dev),
                v_cache[rows, :, cols].to(dev), valid)])
        o, m, l = (torch.stack(t) for t in zip(*parts))   # (n, b,K,G[,hd])
        m_g = m.amax(dim=0)
        scale = torch.exp(m - m_g)
        l_g = (l * scale).sum(dim=0)
        o_g = (o * scale[..., None]).sum(dim=0)
        out.append((o_g / torch.clamp(l_g, min=1e-30)[..., None])
                   .to(q.dtype))
    return torch.cat(out).reshape(B, H, hd)


def reference_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               pos: torch.Tensor) -> torch.Tensor:
    """Unsharded oracle for the combine math."""
    B, H, hd = q.shape
    K, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, K, H // K, hd)
    s = torch.einsum("bkgh,bksh->bkgs", qg, k_cache) / _scale(hd, q.dtype)
    valid = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s.float(), NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksh->bkgh", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, H, hd)
