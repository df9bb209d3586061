"""Client-update compression: the int8 and top-k codecs.

Two schemes shrink the update a client ships (core/compress.py wraps them
with error feedback):

  int8 per-chunk quantization — the flat update is cut into rows of
      ``chunk`` values; each row carries one fp32 scale, absmax·fl32(1/127),
      and int8 codes q = round_half_even(x/scale).  Payload: 1 byte a
      parameter and 4 bytes a chunk.
  top-k sparsification — keep the k largest |x| (ties go to the lowest
      index, as ``lax.top_k`` orders them) and zero the rest.  Payload: 8
      bytes a kept entry (int32 index and fp32 value).

The scale multiplies by the fp32 reciprocal of 127 rather than dividing by
127: the JAX package's jitted ``int8_encode`` computes it so (XLA rewrites
its division by a constant), and the port matches that function bit for
bit, not its eager oracle, which differs in the last bit of some scales.

Each kernel wrapper (``int8_encode``, ``int8_decode``, ``topk_mask``)
checks its inputs, then runs the plain PyTorch version beside it on a CPU
tensor or launches the hand-written CUDA kernel (``csrc/compress.cu``) on
a CUDA tensor; any other device raises, and so does an input that
requires grad under grad mode (``build.refuse_grad``: no backward).  Each
counts its launches in its ``launches`` attribute.  Kernel and plain version agree to the last bit.
``topk_encode`` and ``topk_decode`` are plain PyTorch around ``topk_mask``,
as in the JAX package, where ``lax.top_k`` and the scatter sit outside the
Pallas body.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

COMPRESS_SCHEMES = ("none", "topk", "int8")   # the codecs of core/compress.py
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)   # fl32(1/127)
_MAX_ROWS = 2 ** 31 - 1      # chunk rows a launch takes (one warp each)

_vp, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "int8_encode_launch": [_vp, _vp, _vp, _ll, _int, _ll, _int, _vp],
    "int8_decode_launch": [_vp, _vp, _vp, _ll, _int, _ll, _int, _vp],
    "topk_mask_launch": [_vp, _vp, _vp, _vp, _ll, _int, _vp],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    return build.bind("compress", _SIGNATURES)


def _check_device(name: str, x: torch.Tensor, **others: torch.Tensor):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda tensors, got "
                         f"{x.device}")
    for what, t in others.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, input on "
                             f"{x.device}")


def _check_flat(name: str, x: torch.Tensor) -> None:
    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"{name} takes a non-empty (P,) vector, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous vector")


def _one_value(name: str, v, x: torch.Tensor, dtypes) -> torch.Tensor:
    """``v`` (a number, or a one-element tensor on x's device) as a (1,)
    tensor on x's device."""
    if isinstance(v, torch.Tensor):
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, input on {x.device}")
        if v.numel() != 1:
            raise ValueError(f"{name} must hold one value, got shape "
                             f"{tuple(v.shape)}")
    t = torch.as_tensor(v, device=x.device).reshape(1)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    return t


# ---------------------------------------------------------------- int8
def int8_encode_plain(x: torch.Tensor, chunk: int = 256
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``int8_encode``, the arithmetic of the kernel."""
    P = x.numel()
    n_chunks = -(-P // chunk)
    xm = torch.zeros(n_chunks * chunk, dtype=torch.float32, device=x.device)
    xm[:P] = x
    xm = xm.view(n_chunks, chunk)
    absmax = xm.abs().amax(dim=1)
    scale = torch.where(absmax > 0, absmax * _INV127,
                        torch.ones_like(absmax))
    q = torch.round(xm / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_encode(x: torch.Tensor, chunk: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (P,) float32 → (q (n_chunks, chunk) int8, scale (n_chunks,)
    float32), n_chunks = ceil(P / chunk).  Values past P count as 0 and
    code to 0."""
    build.refuse_grad("int8_encode", x)
    _check_flat("int8_encode", x)
    if int(chunk) != chunk or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")
    _check_device("int8_encode", x)
    P = x.numel()
    n_chunks = -(-P // chunk)
    if n_chunks > _MAX_ROWS:
        raise ValueError(f"{n_chunks} chunks; a launch takes {_MAX_ROWS}")
    if x.device.type == "cpu":
        return int8_encode_plain(x, chunk)
    lib = _library()
    q = torch.empty((n_chunks, chunk), dtype=torch.int8, device=x.device)
    scale = torch.empty(n_chunks, dtype=torch.float32, device=x.device)
    code = lib.int8_encode_launch(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), P, chunk, n_chunks,
        x.device.index or 0, build.stream(x))
    build.check_status(lib, "compress", code, "int8_encode")
    int8_encode.launches += 1
    return q, scale


int8_encode.launches = 0


def int8_decode_plain(q: torch.Tensor, scale: torch.Tensor,
                      length: int) -> torch.Tensor:
    """Plain version of ``int8_decode``."""
    return (q.float() * scale[:, None]).reshape(-1)[:length]


def int8_decode(q: torch.Tensor, scale: torch.Tensor,
                length: int) -> torch.Tensor:
    """Inverse of ``int8_encode``: (n_chunks, chunk) int8 codes and
    (n_chunks,) float32 scales → a fresh dense (length,) float32 vector,
    length ≤ n_chunks·chunk."""
    build.refuse_grad("int8_decode", q, scale)
    if q.dim() != 2 or q.dtype != torch.int8:
        raise TypeError(f"q must be int8 (n_chunks, chunk), got {q.dtype} "
                        f"{tuple(q.shape)}")
    n_chunks, chunk = q.shape
    if tuple(scale.shape) != (n_chunks,) or scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32 ({n_chunks},), got "
                        f"{scale.dtype} {tuple(scale.shape)}")
    if not q.is_contiguous() or not scale.is_contiguous():
        raise ValueError("q and scale must be contiguous")
    if int(length) != length or not 1 <= length <= n_chunks * chunk:
        raise ValueError(f"length must be in [1, {n_chunks * chunk}], got "
                         f"{length!r}")
    if n_chunks > _MAX_ROWS:
        raise ValueError(f"{n_chunks} chunks; a launch takes {_MAX_ROWS}")
    _check_device("int8_decode", q, scale=scale)
    if q.device.type == "cpu":
        return int8_decode_plain(q, scale, length)
    lib = _library()
    out = torch.empty(length, dtype=torch.float32, device=q.device)
    code = lib.int8_decode_launch(
        q.data_ptr(), scale.data_ptr(), out.data_ptr(), length, chunk,
        n_chunks, q.device.index or 0, build.stream(q))
    build.check_status(lib, "compress", code, "int8_decode")
    int8_decode.launches += 1
    return out


int8_decode.launches = 0


# ---------------------------------------------------------------- top-k
def topk_mask_plain(x: torch.Tensor, tau: torch.Tensor,
                    last_keep: torch.Tensor) -> torch.Tensor:
    """Plain version of ``topk_mask``."""
    ax = x.abs()
    gidx = torch.arange(x.numel(), device=x.device)
    keep = (ax > tau) | ((ax == tau) & (gidx <= last_keep))
    return torch.where(keep, x, torch.zeros((), device=x.device))


def topk_mask(x: torch.Tensor, tau, last_keep) -> torch.Tensor:
    """Dense top-k decode given its threshold: keep x where |x| > tau, or
    |x| == tau at an index ≤ last_keep; zero elsewhere.

    x: (P,) float32.  ``tau`` (the k-th largest |x|) and ``last_keep``
    (the largest kept index among the |x| == tau ties) are numbers or
    one-element tensors on x's device; tensors stay there, so the launch
    needs no host sync.
    """
    build.refuse_grad("topk_mask", x, tau, last_keep)
    _check_flat("topk_mask", x)
    _check_device("topk_mask", x)
    tau = _one_value("tau", tau, x, (torch.float32,))
    last_keep = _one_value("last_keep", last_keep, x,
                           (torch.int32, torch.int64)).long()
    if x.device.type == "cpu":
        return topk_mask_plain(x, tau, last_keep)
    lib = _library()
    out = torch.empty_like(x)
    code = lib.topk_mask_launch(
        x.data_ptr(), tau.data_ptr(), last_keep.data_ptr(), out.data_ptr(),
        x.numel(), x.device.index or 0, build.stream(x))
    build.check_status(lib, "compress", code, "topk_mask")
    topk_mask.launches += 1
    return out


topk_mask.launches = 0


def topk_select(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The top-k of a float32 (P,) vector, 1 ≤ k < P: ``(idx, tau,
    last_keep)`` as ``topk_encode`` and ``topk_mask`` take them, all on
    x's device.

    ``torch.topk`` gives the threshold tau, the k-th largest |x|, but
    promises no order among ties, so the ties are settled without it: of
    the entries with |x| == tau, the r = k − #{|x| > tau} of lowest index
    are kept, and ``last_keep`` is the index of the r-th, found by a
    running count (``cumsum``) and ``searchsorted``.  Nothing syncs with
    the host.
    """
    ax = x.abs()
    top_vals, top_idx = torch.topk(ax, k)
    tau = top_vals[k - 1]
    n_above = (top_vals > tau).sum()
    ties_seen = torch.cumsum(ax == tau, dim=0)
    # the j-th kept tie (j = 1, 2, ...) sits where the running count of
    # ties first reaches j
    slot = torch.arange(k, device=x.device)
    tie_idx = torch.searchsorted(ties_seen, (slot - n_above + 1).clamp(min=1))
    # the entries above tau, by index, then stably by magnitude descending
    by_index = torch.sort(top_idx).values
    order = torch.sort(ax[by_index], descending=True, stable=True).indices
    idx = torch.where(slot < n_above, by_index[order], tie_idx)
    return idx, tau, tie_idx[k - 1]


def topk_encode(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (P,) float → (idx (k,) int32, vals (k,) float32, decoded (P,)
    float32), with ``idx`` in ``lax.top_k`` order: magnitude descending,
    the lowest index first among ties.  ``topk_select`` picks the entries
    and ``topk_mask`` writes the dense decode in one pass."""
    if x.dim() != 1 or x.numel() < 1:
        raise ValueError(f"topk_encode takes a non-empty (P,) vector, got "
                         f"shape {tuple(x.shape)}")
    if int(k) != k or k < 1:
        raise ValueError(f"k must be a positive int, got {k!r}")
    P = x.numel()
    xf = x.float().contiguous()
    if k >= P:                      # degenerate: keep everything
        return (torch.arange(P, dtype=torch.int32, device=x.device), xf, xf)
    idx, tau, last_keep = topk_select(xf, k)
    return idx.to(torch.int32), xf[idx], topk_mask(xf, tau, last_keep)


def topk_decode(idx: torch.Tensor, vals: torch.Tensor,
                length: int) -> torch.Tensor:
    """Scatter the (idx, vals) wire format back to a dense (length,)
    float32 vector (the counterpart of the masked decode)."""
    out = torch.zeros(length, dtype=torch.float32, device=vals.device)
    return out.index_put_((idx.long(),), vals.float())
