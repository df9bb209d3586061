"""Flash attention: causal, windowed, soft-capped GQA attention with an
online softmax in fp32 (forward only: under autograd it raises).

q is (B, H, S, d) and k, v are (B, Hkv, S, d) with H % Hkv == 0; query
head h reads kv head h // (H // Hkv).  Scores are q·kᵀ/sqrt(d), capped as
cap·tanh(s/cap) when ``softcap`` is set, and masked entries (past the
causal diagonal, or ``window`` or more steps back) take the value -1e30
and weight 0.  The output is (B, H, S, d) in q's dtype.  A ``window`` of
None or 0 turns the window off.

``flash_attention`` checks its inputs, then runs the plain PyTorch version
beside it on a CPU tensor or launches a hand-written CUDA kernel
(``csrc/flash_attention.cu``) on a CUDA tensor; any other device raises.
It counts its kernel launches in its ``launches`` attribute.  The kernels
replace the Pallas TPU kernel of the JAX package's
kernels/flash_attention.py (``_flash_kernel``).  The dtype picks the
kernel, with no switch:

- bfloat16 runs on the tensor cores (``wgmma``): the fp32 score is scaled
  after the product, p is rounded to bf16 for p·v, and l is summed from
  the fp32 p.  Against the plain version, which keeps p in fp32, each
  output element moves by at most 2⁻⁸ of its row's Σp|v|/l plus its own
  bf16 rounding (``bf16_bound``).  Its inputs need 16-byte-aligned rows:
  a 16-byte aligned ``data_ptr`` and batch, head and time strides that
  are multiples of 8 elements (``check_kernel_layout`` raises otherwise;
  nothing is copied).
- float32 runs on fp32 FMAs, with q scaled before the product as the
  reference does, and agrees with the plain version to fp32 rounding.

Both take q, k and v with any batch, head and time strides as long as the
head dimension is contiguous, so the swapaxes views that
models/attention.py passes are read in place; the output is a fresh
contiguous tensor.
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

BF16_ALIGN_BYTES = 16        # the bf16 tensor maps need 16-byte-aligned rows
# bf16_bound: 2⁻⁷ of |want| for the two outputs' rounding, 2⁻⁸ of Σp|v|/l
# for p's rounding plus 2⁻¹¹ of it for the fp32 arithmetic done apart
BF16_RTOL = 2.0 ** -7
BF16_ABS_V_SHARE = 2.0 ** -8 + 2.0 ** -11

# the C entry point of each dtype's kernel
_ENTRY = {torch.float32: "flash_attention_fp32",
          torch.bfloat16: "flash_attention_bf16"}

_vp, _int, _ll, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
_ARGS = [_vp, _vp, _vp, _vp, _int, _int, _int, _int, _int, *([_ll] * 9),
         _int, _int, _f32, _f32, _int, _vp]
_SIGNATURES = {name: _ARGS for name in _ENTRY.values()}


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
    if q.dtype not in _ENTRY:
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


def check_kernel_layout(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise if the card's kernel cannot read q, k and v in place: a head
    dim above 256 or not contiguous, and for bf16 a ``data_ptr`` that is
    not 16-byte aligned or a batch, head or time stride that is not a
    multiple of 8 elements (a dim of size 1 is never stepped, so its
    stride is free).  Decided before any launch, on any device."""
    d = q.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be contiguous in the head dim")
    if q.dtype != torch.bfloat16:
        return
    step = BF16_ALIGN_BYTES // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % BF16_ALIGN_BYTES:
            raise ValueError(f"bf16 {name} must start at a 16-byte aligned "
                             f"address (data_ptr % 16 = "
                             f"{t.data_ptr() % BF16_ALIGN_BYTES})")
        bad = [st for n, st in zip(t.shape[:3], t.stride()[:3])
               if n > 1 and st % step]
        if bad:
            raise ValueError(f"bf16 {name}'s batch, head and time strides "
                             f"must be multiples of {step} elements, got "
                             f"{tuple(t.stride()[:3])}")


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


def bf16_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               want: torch.Tensor, causal: bool = True,
               window: Optional[int] = None,
               softcap: float = 0.0) -> torch.Tensor:
    """The bound on each element of the bf16 kernel's output against
    ``want = flash_attention_plain(q, k, v, ...)``, in fp32:

        |got - want| <= 2⁻⁷·|want| + (2⁻⁸ + 2⁻¹¹)·A,  A = Σ_j p_j|v_j| / l,

    A being the plain version on |v| (the row's weights, the element's
    column of v).  bf16 keeps 8 significant bits, so rounding a weight to
    it moves the weight by at most 2⁻⁸ of itself; with l summed from the
    fp32 p, as the kernel sums it, the output moves by at most 2⁻⁸·A.  Both
    outputs are then rounded to bf16, 2⁻⁸ of |want| each (2⁻⁷ together).
    2⁻¹¹·A is the slack for the fp32 arithmetic the two sides do apart:
    the score's summation order, the online rescaling and the second-order
    terms of the two bounds above."""
    a = flash_attention_plain(q.float(), k.float(), v.float().abs(), causal,
                              window, softcap)
    return BF16_RTOL * want.float().abs() + BF16_ABS_V_SHARE * a


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: float = 0.0) -> torch.Tensor:
    """Attention of q (B, H, S, d) over k, v (B, Hkv, S, d), float32 or
    bfloat16, on one device → a fresh (B, H, S, d) tensor in q's dtype.
    On the card the inputs must pass ``check_kernel_layout``.  It has no
    backward: under autograd it raises (``build.refuse_grad``), on the CPU
    too, as ``jax.grad`` raises on the Pallas kernel."""
    build.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window, softcap)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window, softcap)
    check_kernel_layout(q, k, v)
    B, H, S, d = q.shape
    lib = _library()
    out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    code = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, k.shape[1], S, d, *strides, int(causal),
        int(window) if window else 0, float(softcap), 1.0 / (d ** 0.5),
        q.device.index or 0, build.stream(q))
    build.check_status(lib, "flash_attention", code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
