"""Flash attention: causal, windowed, soft-capped GQA attention with an
online softmax in fp32 (forward only).

q is (B, H, S, d) and k, v are (B, Hkv, S, d) with H % Hkv == 0; query
head h reads kv head h // (H // Hkv).  q is scaled by 1/sqrt(d) in fp32
before the product, scores are capped as cap·tanh(s/cap) when ``softcap``
is set, and masked entries (past the causal diagonal, or ``window`` or
more steps back) take the value -1e30 and weight 0.  The output is
(B, H, S, d) in q's dtype.  A ``window`` of None or 0 turns the window off.

``flash_attention`` checks its inputs, then runs the plain PyTorch version
beside it on a CPU tensor or launches the hand-written CUDA kernel
(``csrc/flash_attention.cu``) on a CUDA tensor; any other device raises.
It counts its kernel launches in its ``launches`` attribute.  The kernel
replaces the Pallas TPU kernel of the JAX package's
kernels/flash_attention.py (``_flash_kernel``).  It takes q, k and v with
any batch, head and time strides as long as the head dimension is
contiguous, so the swapaxes views that models/attention.py passes are
read in place; the output is a fresh contiguous tensor.  The kernel's
online softmax sums in another order than the plain version's full
softmax, so the two agree to fp32 rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG = -1e30                  # the mask value of the reference kernel
MIN_L = 1e-30                # its floor on the softmax denominator
MAX_HEAD_DIM = 256           # the kernel pads d to 64, 128 or 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _ll, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
_SIGNATURES = {
    "flash_attention_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                               _int, *([_ll] * 9), _int, _int, _f32, _f32,
                               _int, _int, _vp],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    return build.bind("flash_attention", _SIGNATURES)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: float) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, S, d) and k, v (B, Hkv, S, d), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or \
            k.shape[2:] != q.shape[2:]:
        raise ValueError(f"k and v must be ({B}, Hkv, {S}, {d}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if min(B, H, S, d, Hkv) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    if H % Hkv:
        raise ValueError(f"H = {H} query heads is not a multiple of "
                         f"Hkv = {Hkv} kv heads")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0, got {window}")
    if softcap < 0:
        raise ValueError(f"softcap must be >= 0, got {softcap}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: float = 0.0) -> torch.Tensor:
    """Plain version of ``flash_attention``: the full (S, S) scores in fp32,
    scaled, capped and masked as the kernel does, one softmax with the
    kernel's mask value and denominator floor."""
    B, H, S, d = q.shape
    Hkv = k.shape[1]
    qf = q.float() * (1.0 / (d ** 0.5))
    qf = qf.reshape(B, Hkv, H // Hkv, S, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    idx = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window:
        mask &= (idx[:, None] - idx[None, :]) < window
    s = torch.where(mask, s, NEG)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=MIN_L)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / l
    return out.reshape(B, H, S, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention of q (B, H, S, d) over k, v (B, Hkv, S, d), float32 or
    bfloat16, on one device → a fresh (B, H, S, d) tensor in q's dtype.
    On the card the head dimension must be contiguous and at most 256."""
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap)
    B, H, S, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in the head dim")
    lib = _library()
    out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, k.shape[1], S, d, *strides, int(causal),
        int(window) if window else 0, float(softcap), 1.0 / (d ** 0.5),
        _DTYPE_CODES[q.dtype], q.device.index or 0, build.stream(q))
    build.check_status(lib, "flash_attention", code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
