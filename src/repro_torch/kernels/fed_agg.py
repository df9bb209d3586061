"""Staleness-weighted federated aggregation and the fused server step.

The FL server's hotspot (paper §V-D, Eq. 3) is the weighted sum of K
client updates, w = Σ_k c_k · W_k, taken over a (K, P) matrix of
flattened updates.  ``fed_agg_apply`` extends the same layout into the
whole server-optimizer step of the merge pipeline (core/merge.py):
Δ = mix·(Σ_k c_k·W_k − w), the FedAvgM / FedAdagrad / FedAdam / FedYogi
moment update (Reddi et al., arXiv:2003.00295), w' = w + lr·step, and
Σ Δ² for the ‖Δ‖₂ diagnostic.

Each wrapper checks its inputs, then runs the plain PyTorch version on
a CPU tensor or launches the hand-written CUDA kernel
(``csrc/fed_agg.cu``) on a CUDA tensor.  Any other device raises, and so
does an input that requires grad under grad mode (``build.refuse_grad``:
the kernels have no backward; the FL merge runs without a graph).  Each
wrapper counts its kernel launches in its ``launches`` attribute.  The
plain versions take the K-sum in the kernels' order, k = 0, 1, …, with
one rounding per multiply and per add, so on the same inputs kernel and
plain version agree to the last bit except in ‖Δ‖₂, whose sum of
squares is split over blocks.  The update matrix may be a column slab of
a wider matrix: its rows must be contiguous, and the kernels take their
stride.

``fed_agg_sharded`` and ``fed_agg_apply_sharded`` split the P dim over
the devices of a ``launch.mesh.Mesh`` (the counterparts of the JAX
package's ``shard_map`` wrappers): zero-pad P to a multiple of the mesh
size, run the unsharded wrapper on each device's slab, sum the per-slab
Σ Δ² in fp32 on the first device and take one square root, and gather
the outputs there (``fed_agg_sharded`` writes its slabs straight into one
output there instead).  They launch the same two kernels per slab.

The kernels replace the Pallas TPU kernels of the JAX package's
kernels/fed_agg.py (``_fed_agg_kernel`` and ``_make_apply_kernel``).  Both
are bound by device-memory bytes, not arithmetic: see the note at the top
of csrc/fed_agg.cu for how their streaming design answers that.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..sharding.rules import shard_slices
from . import build

# optimizer families the fused kernel computes; "sgd"/"fedavgm" share the
# heavy-ball branch (momentum 0 reduces to plain server-SGD)
APPLY_OPTS = ("sgd", "fedavgm", "fedadagrad", "fedadam", "fedyogi")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CLIENTS = 12288          # K coefficients staged in 48 KB of shared memory
_THREADS = 256               # threads per block, as in csrc/fed_agg.cu
_MAX_APPLY_BLOCKS = 4096     # grid cap; one Σ Δ² partial per block

_vp, _int, _ll, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
_SIGNATURES = {
    "fed_agg_launch": [_vp, _vp, _vp, _int, _ll, _ll, _int, _int, _vp],
    "fed_agg_apply_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                             _int, _int, _ll, _ll, _int, _int, _f32, _f32,
                             _f32, _f32, _f32, _int, _vp],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures."""
    return build.bind("fed_agg", _SIGNATURES)


# ------------------------------------------------------------- checks
def _check_updates(updates: torch.Tensor, coeffs: torch.Tensor) -> None:
    if updates.dim() != 2:
        raise ValueError(f"updates must be (K, P), got shape "
                         f"{tuple(updates.shape)}")
    K, P = updates.shape
    if K < 1 or P < 1:
        raise ValueError(f"updates must be non-empty, got {K}x{P}")
    if K > MAX_CLIENTS:
        raise ValueError(f"at most {MAX_CLIENTS} updates per merge, got {K}")
    if updates.dtype not in _DTYPE_CODES:
        raise TypeError(f"updates must be float32 or bfloat16, got "
                        f"{updates.dtype}")
    if tuple(coeffs.shape) != (K,) or coeffs.dtype != torch.float32:
        raise TypeError(f"coeffs must be float32 ({K},), got "
                        f"{coeffs.dtype} {tuple(coeffs.shape)}")
    if (updates.stride(1) != 1 or (K > 1 and updates.stride(0) < P)
            or not coeffs.is_contiguous()):
        raise ValueError("updates must have contiguous rows and coeffs "
                         "must be contiguous")
    if updates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fed_agg runs on cpu or cuda tensors, got "
                         f"{updates.device}")
    if coeffs.device != updates.device:
        raise ValueError(f"coeffs on {coeffs.device}, updates on "
                         f"{updates.device}")


def _check_vectors(updates: torch.Tensor, **vecs: torch.Tensor) -> None:
    P = updates.shape[1]
    for name, x in vecs.items():
        if tuple(x.shape) != (P,) or x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 ({P},), got "
                            f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != updates.device:
            raise ValueError(f"{name} on {x.device}, updates on "
                             f"{updates.device}")


def _row_stride(updates: torch.Tensor) -> int:
    """Elements from one row of the update matrix to the next."""
    K, P = updates.shape
    return updates.stride(0) if K > 1 else P


# ------------------------------------------------------------- fed_agg
def _weighted_sum_plain(updates: torch.Tensor,
                        coeffs: torch.Tensor) -> torch.Tensor:
    """Σ_k c_k·U[k] in fp32, k in order, one rounding per op (as the
    kernel takes it)."""
    acc = torch.zeros(updates.shape[1], dtype=torch.float32,
                      device=updates.device)
    c = coeffs.float()
    for k in range(updates.shape[0]):
        acc = acc + c[k] * updates[k].float()
    return acc


def fed_agg_plain(updates: torch.Tensor,
                  coeffs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``fed_agg`` (kernels/ref.py ``fed_agg_ref``):
    (K, P), (K,) → (P,) in the updates' dtype, accumulated in fp32."""
    return _weighted_sum_plain(updates, coeffs).to(updates.dtype)


def fed_agg(updates: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Weighted sum of K stacked updates: out[p] = Σ_k c[k]·U[k, p].

    updates: (K, P) float32 or bfloat16; coeffs: (K,) float32 on the same
    device.  Returns a fresh (P,) tensor in the updates' dtype.
    """
    build.refuse_grad("fed_agg", updates, coeffs)
    _check_updates(updates, coeffs)
    if updates.device.type == "cpu":
        return fed_agg_plain(updates, coeffs)
    return _fed_agg_into(updates, coeffs, torch.empty(
        updates.shape[1], dtype=updates.dtype, device=updates.device))


fed_agg.launches = 0


def _fed_agg_into(updates: torch.Tensor, coeffs: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """``fed_agg`` of checked inputs written into ``out``, a contiguous
    (P,) tensor of the updates' dtype on their device (a slice of a wider
    output); returns it."""
    if updates.device.type == "cpu":
        return out.copy_(fed_agg_plain(updates, coeffs))
    lib = _library()
    K, P = updates.shape
    code = lib.fed_agg_launch(
        updates.data_ptr(), coeffs.data_ptr(), out.data_ptr(), K, P,
        _row_stride(updates), _DTYPE_CODES[updates.dtype],
        updates.device.index or 0, build.stream(updates))
    build.check_status(lib, "fed_agg", code, "fed_agg")
    fed_agg.launches += 1
    return out


# ------------------------------------------------------- fed_agg_apply
def _f32(x) -> float:
    """A Python float holding the fp32 rounding of ``x``."""
    return float(np.float32(x))


def fed_agg_apply_plain(updates: torch.Tensor, coeffs: torch.Tensor,
                        params: torch.Tensor, m: torch.Tensor,
                        v: torch.Tensor, lr, mix, b1, b2, eps,
                        opt: str = "fedadam"):
    """Plain version of ``fed_agg_apply`` (kernels/ref.py
    ``fed_agg_apply_ref``): weighted sum → Δ = mix·(s − g) → moment
    update → step, all in fp32 with fp32 hyperparameters.  Returns
    (out, m, v, ‖Δ‖₂)."""
    if opt not in APPLY_OPTS:
        raise ValueError(f"unknown server opt {opt!r}; available: "
                         f"{APPLY_OPTS}")
    lr, mix, b1, b2, eps = (_f32(x) for x in (lr, mix, b1, b2, eps))
    one_b1 = _f32(np.float32(1.0) - np.float32(b1))
    one_b2 = _f32(np.float32(1.0) - np.float32(b2))
    s = _weighted_sum_plain(updates, coeffs)
    g = params.float()
    delta = mix * (s - g)
    m, v = m.float(), v.float()
    if opt in ("sgd", "fedavgm"):
        m = b1 * m + delta
        v = v.clone()
        step = m
    else:
        m = b1 * m + one_b1 * delta
        dsq = delta * delta
        if opt == "fedadagrad":
            v = v + dsq
        elif opt == "fedadam":
            v = b2 * v + one_b2 * dsq
        else:                                            # fedyogi
            v = v - one_b2 * dsq * torch.sign(v - dsq)
        step = m / (torch.sqrt(v) + eps)
    return g + lr * step, m, v, torch.sqrt(torch.sum(delta * delta))


def fed_agg_apply(updates: torch.Tensor, coeffs: torch.Tensor,
                  params: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                  lr, mix, b1, b2, eps, *,
                  opt: str = "fedadam") -> Tuple[torch.Tensor, ...]:
    """Fused server-update step on the flattened model.

    updates: (K, P) float32 or bfloat16; coeffs: (K,) float32;
    params/m/v: (P,) float32, all on one device.  ``opt`` picks the
    optimizer family; lr, mix, b1, b2 and eps are plain numbers (b1 is
    the heavy-ball momentum for sgd/fedavgm).  Returns fresh
    ``(new_params, new_m, new_v, update_norm)`` with
    ``update_norm = ‖Δ‖₂`` a 0-d fp32 tensor on the device.
    """
    build.refuse_grad("fed_agg_apply", updates, coeffs, params, m, v)
    if opt not in APPLY_OPTS:
        raise ValueError(f"unknown server opt {opt!r}; available: "
                         f"{APPLY_OPTS}")
    _check_updates(updates, coeffs)
    _check_vectors(updates, params=params, m=m, v=v)
    if updates.device.type == "cpu":
        return fed_agg_apply_plain(updates, coeffs, params, m, v,
                                   lr, mix, b1, b2, eps, opt=opt)
    lib = _library()
    K, P = updates.shape
    out, m_new, v_new = (torch.empty_like(params) for _ in range(3))
    n_blocks = max(1, min(-(-P // (_THREADS * 4)), _MAX_APPLY_BLOCKS))
    partials = torch.empty(n_blocks, dtype=torch.float32,
                           device=updates.device)
    code = lib.fed_agg_apply_launch(
        updates.data_ptr(), coeffs.data_ptr(), params.data_ptr(),
        m.data_ptr(), v.data_ptr(), out.data_ptr(), m_new.data_ptr(),
        v_new.data_ptr(), partials.data_ptr(), n_blocks, K, P,
        _row_stride(updates), _DTYPE_CODES[updates.dtype],
        APPLY_OPTS.index(opt), lr, mix, b1, b2, eps,
        updates.device.index or 0, build.stream(updates))
    build.check_status(lib, "fed_agg", code, "fed_agg_apply")
    fed_agg_apply.launches += 1
    return out, m_new, v_new, torch.sqrt(partials.sum())


fed_agg_apply.launches = 0


# ------------------------------------------------------------ sharded
def _pad_p(arr: torch.Tensor, mult: int) -> torch.Tensor:
    """Zero-pad the trailing (P) dim to a multiple of ``mult``."""
    pad = (-arr.shape[-1]) % mult
    if not pad:
        return arr
    return torch.nn.functional.pad(arr, (0, pad))


def fed_agg_sharded(updates: torch.Tensor, coeffs: torch.Tensor,
                    mesh) -> torch.Tensor:
    """``fed_agg`` with the P dim split over every device of ``mesh``.

    updates (K, P) is zero-padded to a multiple of the mesh size (0·c adds
    0) and cut into one column slab per device; each slab runs ``fed_agg``
    on its device (a view when that is the updates' device, else a copy).
    The (P_pad,) output is allocated once on the mesh's first device: a
    slab on that device writes its slice in place, a slab on another
    device is copied into its slice, so no gather copies the result again.
    A size-1 mesh is the unsharded call.
    """
    build.refuse_grad("fed_agg_sharded", updates, coeffs)
    if mesh.size <= 1:
        return fed_agg(updates, coeffs)
    _check_updates(updates, coeffs)
    P = updates.shape[1]
    upd = _pad_p(updates, mesh.size)
    home = mesh.devices[0]
    out = torch.empty(upd.shape[1], dtype=updates.dtype, device=home)
    for dev, cols in shard_slices(upd.shape[1], mesh):
        slab, c = upd[:, cols].to(dev), coeffs.to(dev)
        if dev == home:
            _fed_agg_into(slab, c, out[cols])
        else:
            out[cols].copy_(fed_agg(slab, c))
    if home.type == "cuda":
        fed_agg_sharded.launches += 1
    return out[:P]


fed_agg_sharded.launches = 0


def fed_agg_apply_sharded(updates: torch.Tensor, coeffs: torch.Tensor,
                          params: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, lr, mix, b1, b2, eps, *,
                          opt: str = "fedadam",
                          mesh) -> Tuple[torch.Tensor, ...]:
    """``fed_agg_apply`` with the P dim split over every device of ``mesh``.

    Each device owns a P slab of updates, params and moments and runs the
    fused kernel on it; the only cross-slab arithmetic is Σ Δ²: the slabs'
    norms are squared and summed in fp32 on the first device, and one
    square root gives ‖Δ‖₂, as the JAX package's ``psum`` does.  Padded
    tails have zero updates, params and moments, so their Δ, moments and
    outputs stay exactly 0.  Outputs are gathered on the first device.
    """
    build.refuse_grad("fed_agg_apply_sharded", updates, coeffs, params, m, v)
    if mesh.size <= 1:
        return fed_agg_apply(updates, coeffs, params, m, v,
                             lr, mix, b1, b2, eps, opt=opt)
    if opt not in APPLY_OPTS:
        raise ValueError(f"unknown server opt {opt!r}; available: "
                         f"{APPLY_OPTS}")
    _check_updates(updates, coeffs)
    _check_vectors(updates, params=params, m=m, v=v)
    P = updates.shape[1]
    n = mesh.size
    upd = _pad_p(updates, n)
    g2, m2, v2 = (_pad_p(x, n) for x in (params, m, v))
    home = mesh.devices[0]
    parts, sumsq = [], torch.zeros((), dtype=torch.float32, device=home)
    for dev, cols in shard_slices(upd.shape[1], mesh):
        out, m_new, v_new, norm = fed_agg_apply(
            upd[:, cols].to(dev), coeffs.to(dev), g2[cols].to(dev),
            m2[cols].to(dev), v2[cols].to(dev), lr, mix, b1, b2, eps,
            opt=opt)
        parts.append([t.to(home) for t in (out, m_new, v_new)])
        norm = norm.to(home)
        sumsq = sumsq + norm * norm
    if home.type == "cuda":
        fed_agg_apply_sharded.launches += 1
    out, m_new, v_new = (torch.cat(ts)[:P] for ts in zip(*parts))
    return out, m_new, v_new, torch.sqrt(sumsq)


fed_agg_apply_sharded.launches = 0
