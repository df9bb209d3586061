"""Mamba2 SSD chunked scan (state-space duality) in fp32.

With x (b, l, h, p) already scaled by dt, a_dt (b, l, h) = A·dt (≤ 0) and
B, C (b, l, g, n), g dividing h (head i reads group i // (h / g), Mamba2's
``n_groups``; g = h gives each head its own), the scan is the recurrence
    state_t = exp(a_t)·state_{t-1} + x_t ⊗ B_t ;  y_t = state_t · C_t
computed chunk by chunk, as the Pallas TPU kernel of the JAX package's
kernels/ssd_scan.py (``_ssd_kernel``) computes it: within a chunk, with
a_cum = cumsum(a),
    L = exp(where(i ≥ j, a_cum[i] − a_cum[j], −1e30))
    y = ((C·Bᵀ) ⊙ L)·x + exp(a_cum)·(C·stateᵀ)
    state ← exp(a_cum[-1])·state + xᵀ·(B ⊙ exp(a_cum[-1] − a_cum))
from a zero state.  y is (b, l, h, p) in x's dtype; with ``return_state``
the fp32 (b, h, p, n) state after the last position comes back beside it
(``ssd_chunked``'s ``final_state``, the scratch the Pallas kernel carries
to its last grid step), which prefill keeps as the decode cache.

``ssd_scan`` checks its inputs, then runs the plain PyTorch version beside
it on a CPU tensor or launches the hand-written CUDA kernels
(``csrc/ssd_scan.cu``) on a CUDA tensor; any other device raises.  It
counts its calls that launch in its ``launches`` attribute, one a call.
The kernels are chosen by dtype: bf16 inputs (the serve runs' activations)
run the chunk-parallel SSD on the tensor cores in chunks of ``TILE`` = 128
positions (chunk states, the state pass, chunk outputs; every fp32
operand of a product split into a bf16 hi and lo pair, so the products are
fp32-class), with an fp32 workspace that the wrapper allocates; fp32
inputs run the fp32 FMA kernel, which walks the sequence in tiles of 64
positions.  ``chunk`` is the plain version's chunk (the sequence is padded
up to a multiple of it with x = 0 and a_dt = 0, which leaves the state
exact); the kernels use their own and mask the tail.  Kernel and plain
version compute the same function in fp32 and agree to rounding, not bit
for bit.
The kernels read x, B and C with any batch, time and head strides as long
as the last dimension is contiguous, so the head-broadcast views of B and
C that models/ssm.py passes for one group (head stride 0) are read in
place, and so are grouped (b, l, g, n) tensors: no per-head copy either
way.  The plain version computes C·Bᵀ once a group.

The kernels have no backward, as the Pallas kernel has none.  Under
autograd ``ssd_scan`` runs as ``_SSDScan``: the kernels compute the
forward, and the backward recomputes the plain version in fp32 from the
saved inputs and returns its vector-Jacobian product (what ``jax.grad``
of the JAX package's ``ssd_chunked`` computes); grouped B and C get
(b, l, g, n) gradients, summed over each group's heads.  So the kernel runs the
forward of training, and the plain version its backward.  Under
``torch.func.vmap`` (the vectorized executor) ``_SSDScan``'s vmap rule
folds the vmapped dim into the batch, so a call still launches once.

In the sharded train step (launch/sharded.py) the scan's inputs are
DTensors.  ``ssd_scan_sharded`` runs the scan as a ``local_map`` region:
batch sharded over the data axes, heads over the model axis when they
divide it (else the head dim p, else nothing), and the kernels (or the
plain version on the CPU) see each rank's plain local tensors.  B and C
enter replicated over the model axis and are cut to the rank's heads by a
view, so their head-broadcast views keep stride 0.  ``ssd_scan`` itself
refuses a DTensor: ``data_ptr()`` of one is not a device pointer.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..sharding.spmd import act_in, model_shard, region
from . import build

NEG = -1e30                  # the mask value of the reference kernel
MAX_STATE = 128              # the largest n the kernels take
TILE = 128                   # positions of a chunk of the bf16 kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "ssd_scan_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _int, _int,
                        _int, _int, _int, *([_ll] * 12), _int, _int, _int,
                        _vp],
    "ssd_scan_chunk": [],
}


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with its C signatures;
    its bf16 chunk must be ``TILE``, which sizes the workspace."""
    lib = build.bind("ssd_scan", _SIGNATURES)
    if lib.ssd_scan_chunk() != TILE:
        raise RuntimeError(f"csrc/ssd_scan.cu chunks by "
                           f"{lib.ssd_scan_chunk()}, kernels/ssd_scan.py by "
                           f"{TILE}")
    return lib


def workspace_floats(b: int, l: int, h: int, p: int, n: int) -> int:
    """fp32 values of the bf16 kernel's workspace: each chunk's state
    contribution (b, h, c, p, n), then each chunk's decay (b, h, c)."""
    return b * h * -(-l // TILE) * (p * n + 1)


def _check(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, chunk: int) -> None:
    if x.dim() != 4 or a_dt.dim() != 3 or B.dim() != 4 or C.dim() != 4:
        raise ValueError(f"x must be (b, l, h, p), a_dt (b, l, h) and B, C "
                         f"(b, l, g, n), got {tuple(x.shape)}, "
                         f"{tuple(a_dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, l, h, p = x.shape
    if tuple(a_dt.shape) != (b, l, h):
        raise ValueError(f"a_dt must be ({b}, {l}, {h}), got "
                         f"{tuple(a_dt.shape)}")
    if tuple(B.shape[:2]) != (b, l) or tuple(C.shape) != tuple(B.shape) \
            or B.shape[2] < 1 or h % B.shape[2]:
        raise ValueError(f"B and C must be ({b}, {l}, g, n) with g dividing "
                         f"{h}, got {tuple(B.shape)}, {tuple(C.shape)}")
    if min(b, l, h, p, B.shape[3]) < 1:
        raise ValueError(f"empty ssd_scan input {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"x, B and C must share a dtype, got {x.dtype}, "
                        f"{B.dtype}, {C.dtype}")
    if not a_dt.is_floating_point():
        raise TypeError(f"a_dt must be floating point, got {a_dt.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cpu or cuda tensors, got "
                         f"{x.device}")
    if any(t.device != x.device for t in (a_dt, B, C)):
        raise ValueError(f"x on {x.device}, a_dt on {a_dt.device}, B on "
                         f"{B.device}, C on {C.device}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def ssd_scan_plain(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, chunk: int = 128,
                   return_state: bool = False,
                   init_state: Optional[torch.Tensor] = None
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain version of ``ssd_scan``: the chunked algorithm in fp32
    throughout, chunk = min(chunk, l), l padded up to a multiple of it;
    the heads split as (g, r), r = h / g heads a group of B and C.
    ``init_state`` (b, h, p, n) is the state entering the first chunk
    (zero when None); ``models.ssm.ssd_chunked`` passes it."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    q = min(chunk, l)
    c = -(-l // q)
    pad = c * q - l
    xf, af, Bf, Cf = x.float(), a_dt.float(), B.float(), C.float()
    if pad:
        xf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                      for t in (xf, Bf, Cf))
        af = torch.nn.functional.pad(af, (0, 0, 0, pad))
    xc = xf.reshape(b, c, q, g, r, p)
    Bc = Bf.reshape(b, c, q, g, n)
    Cc = Cf.reshape(b, c, q, g, n)
    a_cum = torch.cumsum(af.reshape(b, c, q, h).permute(0, 3, 1, 2), dim=-1)

    # intra-chunk term: (C·Bᵀ ⊙ L)·x, C·Bᵀ once a group
    seg = a_cum[..., :, None] - a_cum[..., None, :]          # (b,h,c,q,q)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask, seg, NEG)).view(b, g, r, c, q, q)
    scores = torch.einsum("bcign,bcjgn->bgcij", Cc, Bc)[:, :, None] * L
    y = torch.einsum("bgrcij,bcjgrp->bcigrp", scores, xc)

    # each chunk's own contribution to the state it hands on
    decay_out = torch.exp(a_cum[..., -1:] - a_cum)           # (b,h,c,q)
    chunk_states = torch.einsum(
        "bcqgn,bgrcq,bcqgrp->bcgrpn", Bc, decay_out.view(b, g, r, c, q),
        xc).reshape(b, c, h, p, n)
    chunk_decay = torch.exp(a_cum[..., -1])                  # (b,h,c)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for ci in range(c):
        entering.append(state)
        state = state * chunk_decay[:, :, ci, None, None] + chunk_states[:, ci]
    entering = torch.stack(entering, dim=1)                  # (b,c,h,p,n)

    # the state entering each chunk, decayed to each position:
    # exp(a_cum)·C·stateᵀ
    y = y + torch.einsum("bcqgn,bcgrpn,bgrcq->bcqgrp", Cc,
                         entering.view(b, c, g, r, p, n),
                         torch.exp(a_cum).view(b, g, r, c, q))
    y = y.reshape(b, c * q, h, p)[:, :l].to(x.dtype)
    return (y, state) if return_state else y


def _scan(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
          C: torch.Tensor, chunk: int, return_state: bool):
    """The scan without a graph: the plain version on a CPU tensor, the
    kernels on a CUDA tensor (counted in ``ssd_scan.launches``)."""
    if x.device.type == "cpu":
        return ssd_scan_plain(x, a_dt, B, C, chunk, return_state)
    b, l, h, p = x.shape
    n = B.shape[-1]
    if n > MAX_STATE:
        raise ValueError(f"the kernel takes state dims up to {MAX_STATE}, "
                         f"got {n}")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("x, B and C must be contiguous in their last dim")
    a = a_dt.float()
    lib = _library()
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if return_state else None)
    work = (torch.empty(workspace_floats(b, l, h, p, n), dtype=torch.float32,
                        device=x.device)
            if x.dtype == torch.bfloat16 else None)
    strides = [st for t in (x, a, B, C) for st in t.stride()[:3]]
    code = lib.ssd_scan_launch(
        x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        state.data_ptr() if return_state else None,
        work.data_ptr() if work is not None else None, b, l, h, p, n,
        *strides, h // B.shape[2], _DTYPE_CODES[x.dtype],
        x.device.index or 0, build.stream(x))
    build.check_status(lib, "ssd_scan", code, "ssd_scan")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


def _fold(t: torch.Tensor, bdim: Optional[int], size: int) -> torch.Tensor:
    """``t`` with its vmapped dim ``bdim`` (None: not vmapped, so ``t`` is
    expanded to ``size`` copies) folded into its batch dim: (size·b, ...).
    A dim of stride 0 past the batch (B and C's head broadcast) is folded
    at size 1 and expanded back, so the fold copies at most the
    unexpanded tensor, never the broadcast heads; the last dim comes out
    contiguous, as the kernels read it."""
    t = (t.unsqueeze(0).expand(size, *t.shape) if bdim is None
         else t.movedim(bdim, 0))
    shape = (t.shape[0] * t.shape[1], *t.shape[2:])
    base = t
    for d in range(2, t.dim()):
        if t.stride(d) == 0:
            base = base.narrow(d, 0, 1)
    base = base.reshape(shape[0], *base.shape[2:])
    if base.stride(-1) != 1:
        base = base.contiguous()
    return base.expand(shape)


class _SSDScan(torch.autograd.Function):
    """The scan under autograd and ``torch.func``.  The forward is
    ``_scan`` (the kernels on the card); the backward is the
    vector-Jacobian product of ``ssd_scan_plain`` in fp32, recomputed from
    the saved inputs by ``torch.func.vjp`` (so ``torch.func.grad`` traces
    it too), which is what ``jax.grad`` differentiates in the JAX package
    (``ssd_chunked``: no Pallas kernel there has a backward either).  The
    inputs are saved as they came, so the head-broadcast views of B and C
    stay views; their grads come back at the views' shape, and autograd
    sums them over the heads through the ``expand`` that made the views.
    All state lives in ``ctx``, so ``torch.utils.checkpoint`` can re-run
    the forward.

    Under ``torch.func.vmap`` (the vectorized executor trains a cohort
    through ``vmap(grad_and_value(...))``) the ``vmap`` rule folds the
    vmapped dim into the scan's batch dim, so the kernels still launch
    once a call, at (V·b, l, h, p); ``_scan`` reads ``data_ptr()``, so no
    generated rule can serve."""

    @staticmethod
    def forward(x, a_dt, B, C, chunk, return_state):
        return _scan(x, a_dt, B, C, chunk, return_state)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, a_dt, B, C, chunk, _ = inputs
        ctx.save_for_backward(x, a_dt, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, gy, gstate=None):
        need = ctx.needs_input_grad[:4]
        saved = ctx.saved_tensors
        # an output whose grad is None went unused: it counts as zero
        used = [i for i, g in enumerate((gy, gstate)) if g is not None]
        if not used or not any(need):
            return None, None, None, None, None, None
        wrt = [i for i in range(4) if need[i]]

        def plain(*args):
            inputs = list(saved)
            for i, t in zip(wrt, args):
                inputs[i] = t
            outs = ssd_scan_plain(*inputs, ctx.chunk, return_state=True)
            return tuple(outs[i] for i in used)

        # registered in tracing.SPANS; opened whether tracing is on or not
        with torch.profiler.record_function("ssd_scan_plain_backward"):
            _, vjp_fn = torch.func.vjp(plain, *(saved[i] for i in wrt))
            grads = iter(vjp_fn(tuple((gy, gstate)[i] for i in used)))
        return (*(next(grads) if n else None for n in need), None, None)

    @staticmethod
    def vmap(info, in_dims, x, a_dt, B, C, chunk, return_state):
        size = info.batch_size
        folded = [_fold(t, d, size) for t, d in
                  zip((x, a_dt, B, C), in_dims[:4])]
        unfold = (size, folded[0].shape[0] // size)
        out = _SSDScan.apply(*folded, chunk, return_state)
        if not return_state:
            return out.unflatten(0, unfold), 0
        y, state = out
        return (y.unflatten(0, unfold), state.unflatten(0, unfold)), (0, 0)


def ssd_scan(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int = 128, return_state: bool = False
             ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The SSD scan of x (b, l, h, p), a_dt (b, l, h), B and C (b, l, g, n)
    (g dividing h; head i reads group i // (h / g)), x, B and C float32 or
    bfloat16 on one device → a fresh (b, l, h, p)
    tensor in x's dtype, and with ``return_state`` the fp32 (b, h, p, n)
    final state.  On the card n must be at most 128 and the last dimension
    of x, B and C contiguous.  Differentiable: with grad mode on and an
    input that requires grad autograd records ``_SSDScan``, whose
    backward is the plain version's.  Raises ``TypeError`` on a DTensor
    (``ssd_scan_sharded`` takes those)."""
    build.refuse_dtensor("ssd_scan", x, a_dt, B, C)
    _check(x, a_dt, B, C, chunk)
    return _SSDScan.apply(x, a_dt, B, C, chunk, return_state)


ssd_scan.launches = 0


def ssd_scan_sharded(x: DTensor, a_dt: DTensor, B: DTensor, C: DTensor,
                     chunk: int = 128, return_state: bool = False):
    """``ssd_scan`` of DTensors as a ``local_map`` region (module
    docstring): y comes back laid out as the region computed it (batch
    over the data axes, heads or p over the model axis), and with
    ``return_state`` the state (b, h, p, n) beside it."""
    rank, size = model_shard(x.device_mesh)
    h, p = x.shape[2], x.shape[3]
    if B.shape[2] != h:
        raise ValueError(f"ssd_scan_sharded takes B and C per head (or "
                         f"head-broadcast), got {B.shape[2]} groups for "
                         f"{h} heads")
    # the model axis splits the heads, else the head dim, else nothing
    split = 2 if h % size == 0 else 3 if p % size == 0 else None
    x_on = Shard(split) if split else Replicate()
    state_on = Shard(split - 1) if split else Replicate()

    def local(x_l, a_l, B_l, C_l):
        if split == 2:
            n = x_l.shape[2]
            B_l = B_l.narrow(2, rank * n, n)
            C_l = C_l.narrow(2, rank * n, n)
        return ssd_scan(x_l, a_l, B_l, C_l, chunk, return_state)

    return region(local, [act_in(x, x_on),
                          act_in(a_dt, Shard(2) if split == 2
                                 else Replicate()),
                          act_in(B), act_in(C)],
                  (x_on, state_on) if return_state else x_on)
