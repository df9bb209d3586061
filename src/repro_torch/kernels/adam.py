"""The local Adam / AdamW step on a whole params tree in one pass.

Every FL client trains with a local optimizer; the executor runs K clients
at once on (K, ...) stacked trees, so Adam's elementwise passes dominate a
local step.  ``adam`` takes the leaves of one tree (params, grads and the
fp32 moments as lists of tensors) and, for every element, adds the FedProx
term mu·(p − anchor) to the grad when an anchor is given, updates both
moments, takes the bias-corrected step, subtracts the decoupled weight
decay when it is set, and adds the step to the param (``apply=True``) or
returns the fp32 step itself (``apply=False``, ``Optimizer.update``).

The wrapper checks its inputs, then runs the plain PyTorch version
(``adam_plain``) on CPU tensors or launches the hand-written CUDA kernel
(``csrc/adam.cu``) on CUDA tensors, one launch for each ``MAX_LEAVES``
leaves of one dtype; it counts those launches in ``adam.launches``.  Any
other device raises, and so do CUDA leaves of dtypes the kernel does not
take (``check_kernel_dtypes``: params fp32 or bf16, grads and the anchor
in the params' dtype, moments fp32), a DTensor (``build.refuse_dtensor``: the optimizer
hands over each rank's local shards) and an input that requires grad under
grad mode.  The outputs are new tensors; the inputs are not written.

The plain version is the port's Adam as PyTorch's eager passes compute it,
and the kernel rounds as those passes do on the card: fp32 scalars taken
from the Python numbers (``1 - b1`` in double first), a division by a
bias correction a product by its reciprocal (taken in double, then
rounded to fp32), bf16 rounded after each pass that outputs bf16.  Kernel and plain version agree to the last bit.

Replaces no Pallas kernel: the JAX package's Adam is ``jnp`` under ``jit``
(XLA fuses it); see the note at the top of csrc/adam.cu.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

MAX_LEAVES = 36               # leaves in one launch's table (csrc/adam.cu)
PLAIN_SLICE = 1 << 22         # elements of a slice of adam_plain's passes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "adam_launch": [_vp, _vp, _int, _int, _int, *[_f32] * 10, _int, _int,
                    _vp],
}

Leaves = Sequence[torch.Tensor]


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with its C signature."""
    return build.bind("adam", _SIGNATURES)


def _f32(x) -> float:
    """A Python float holding the fp32 rounding of ``x``."""
    return float(np.float32(x))


def _passes(p, g, m, v, a, *, lr, b1, b2, eps, weight_decay, bc1, bc2, mu,
            apply):
    """PyTorch's passes of one Adam step on one leaf (or a slice of it):
    (new param or fp32 update, m, v)."""
    if a is not None:
        g = g + mu * (p - a).to(g.dtype)
    m = b1 * m + (1 - b1) * g.float()
    v = b2 * v + (1 - b2) * torch.square(g.float())
    upd = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay:
        upd = upd - lr * weight_decay * p.float()
    return (p + upd.to(p.dtype) if apply else upd), m, v


def adam_plain(params: Leaves, grads: Leaves, m: Leaves, v: Leaves, *,
               lr: float, b1: float, b2: float, eps: float,
               weight_decay: float, bc1: float, bc2: float,
               anchor: Optional[Leaves] = None, mu: float = 0.0,
               apply: bool = True
               ) -> Tuple[List[torch.Tensor], ...]:
    """Plain version of ``adam``: leaf by leaf, PyTorch's passes.  A leaf
    of more than PLAIN_SLICE elements runs in slices of its first dim,
    each written into the leaf's outputs, so that the passes' temporaries
    stay small beside the outputs, as the kernel keeps none: the dry run
    counts a train step's peak memory through this version.  Returns
    ``(out, m, v)`` lists, ``out`` the new params with ``apply``, else the
    fp32 updates."""
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              bc1=bc1, bc2=bc2, mu=mu, apply=apply)
    outs, ms, vs = [], [], []
    for i, (p, g, m_, v_) in enumerate(zip(params, grads, m, v)):
        a = anchor[i] if anchor is not None and mu != 0.0 else None
        if p.numel() <= PLAIN_SLICE:
            res = _passes(p, g, m_, v_, a, **kw)
        else:
            rows = max(1, PLAIN_SLICE // (p.numel() // p.shape[0]))
            res = None
            for r in range(0, p.shape[0], rows):
                s = slice(r, r + rows)
                part = _passes(p[s], g[s], m_[s], v_[s],
                               a[s] if a is not None and a.dim() == p.dim()
                               else a, **kw)
                if res is None:
                    res = [torch.empty(p.shape, dtype=t.dtype,
                                       device=t.device) for t in part]
                for whole, t in zip(res, part):
                    whole[s] = t
                del part
        outs.append(res[0])
        ms.append(res[1])
        vs.append(res[2])
    return outs, ms, vs


def _check(params, grads, m, v, anchor) -> torch.device:
    n = len(params)
    if not (len(grads) == len(m) == len(v) == n) or (
            anchor is not None and len(anchor) != n):
        raise ValueError("params, grads, moments and anchor must hold one "
                         "leaf each for every param")
    build.refuse_grad("adam", *params, *grads, *m, *v, *(anchor or ()))
    device = params[0].device if n else torch.device("cpu")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"adam runs on cpu or cuda tensors, got {device}")
    for i in range(n):
        p = params[i]
        for name, t in (("grad", grads[i]), ("m", m[i]), ("v", v[i])):
            if t.shape != p.shape:
                raise ValueError(f"leaf {i}: {name} {tuple(t.shape)} against "
                                 f"param {tuple(p.shape)}")
        if anchor is not None and tuple(
                p.shape[p.dim() - anchor[i].dim():]) != tuple(anchor[i].shape):
            raise ValueError(f"leaf {i}: anchor {tuple(anchor[i].shape)} is "
                             f"not the trailing shape of the param "
                             f"{tuple(p.shape)}")
        leaf = [p, grads[i], m[i], v[i], *([anchor[i]] if anchor else [])]
        if any(t.device != device for t in leaf):
            raise ValueError(f"leaf {i}: inputs on {[t.device for t in leaf]}"
                             f", expected all on {device}")
    return device


def check_kernel_dtypes(params: Leaves, grads: Leaves, m: Leaves,
                        v: Leaves, anchor: Optional[Leaves] = None) -> None:
    """Raise ``TypeError`` unless the kernel takes these leaves' dtypes:
    params fp32 or bf16, grads and the anchor in the params' dtype,
    moments fp32.  ``adam`` calls it on CUDA leaves; the plain version
    takes any floating dtypes."""
    for i, p in enumerate(params):
        if (p.dtype not in _DTYPE_CODES or grads[i].dtype != p.dtype
                or m[i].dtype != torch.float32 or v[i].dtype != torch.float32
                or (anchor is not None and anchor[i].dtype != p.dtype)):
            raise TypeError(
                f"adam's kernel takes fp32 or bf16 params, grads and an "
                f"anchor in the params' dtype and fp32 moments; leaf {i} has "
                f"param {p.dtype}, grad {grads[i].dtype}, moments "
                f"{m[i].dtype}/{v[i].dtype}"
                + (f", anchor {anchor[i].dtype}" if anchor else ""))


def adam(params: Leaves, grads: Leaves, m: Leaves, v: Leaves, *,
         lr: float, b1: float, b2: float, eps: float, weight_decay: float,
         bc1: float, bc2: float, anchor: Optional[Leaves] = None,
         mu: float = 0.0, apply: bool = True
         ) -> Tuple[List[torch.Tensor], ...]:
    """One Adam / AdamW step over a tree's leaves.

    params, grads, m, v (and anchor, used when ``mu`` ≠ 0): one tensor a
    leaf; grads, m and v shaped as their param, the anchor as the param's
    trailing dims (a (K, ...) stacked leaf repeats it K times).  lr, b1,
    b2, eps and weight_decay are Python numbers; bc1 and bc2 the bias
    corrections ``1 − b**count`` (fp32 values).  Returns fresh lists
    ``(out, m, v)``: out the new params with ``apply``, else the fp32
    updates to add.
    """
    params, grads, m, v = (list(x) for x in (params, grads, m, v))
    anchor = list(anchor) if anchor is not None and mu != 0.0 else None
    device = _check(params, grads, m, v, anchor)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              bc1=bc1, bc2=bc2, mu=mu, apply=apply)
    if device.type == "cpu":
        return adam_plain(params, grads, m, v, anchor=anchor, **kw)
    check_kernel_dtypes(params, grads, m, v, anchor)
    return _launch(params, grads, m, v, anchor, **kw)


adam.launches = 0


def _launch(params, grads, m, v, anchor, *, lr, b1, b2, eps, weight_decay,
            bc1, bc2, mu, apply):
    """The kernel over checked CUDA leaves: one launch a table of up to
    MAX_LEAVES leaves of one dtype."""
    lib = _library()
    hyper = (_f32(-lr), _f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
             _f32(1.0 / bc1), _f32(1.0 / bc2), _f32(eps),
             _f32(lr * weight_decay), _f32(mu))
    n = len(params)
    p_in = [t.contiguous() for t in params]
    cols = [[t.contiguous() for t in x] for x in (grads, m, v)]
    a_in = [t.contiguous() for t in anchor] if anchor is not None else None
    outs = [torch.empty(p.shape, dtype=p.dtype if apply else torch.float32,
                        device=p.device) for p in p_in]
    m_out, v_out = ([torch.empty(p.shape, dtype=torch.float32,
                                 device=p.device) for p in p_in]
                    for _ in range(2))
    groups = {}
    for i in range(n):
        groups.setdefault(p_in[i].dtype, []).append(i)
    device = p_in[0].device if n else None
    for dtype, idx in groups.items():
        for start in range(0, len(idx), MAX_LEAVES):
            chunk = idx[start:start + MAX_LEAVES]
            ptrs = (ctypes.c_void_p * (8 * len(chunk)))()
            sizes = (ctypes.c_longlong * (2 * len(chunk)))()
            for j, i in enumerate(chunk):
                ptrs[8 * j:8 * j + 8] = [
                    p_in[i].data_ptr(), cols[0][i].data_ptr(),
                    cols[1][i].data_ptr(), cols[2][i].data_ptr(),
                    a_in[i].data_ptr() if a_in is not None else None,
                    outs[i].data_ptr(), m_out[i].data_ptr(),
                    v_out[i].data_ptr()]
                sizes[2 * j] = p_in[i].numel()
                sizes[2 * j + 1] = a_in[i].numel() if a_in is not None else 0
            code = lib.adam_launch(
                ptrs, sizes, len(chunk), _DTYPE_CODES[dtype], int(apply),
                *hyper, int(bool(weight_decay)), device.index or 0,
                build.stream(p_in[0]))
            build.check_status(lib, "adam", code, "adam")
            adam.launches += 1
    return outs, m_out, v_out
