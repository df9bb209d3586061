"""The port's ssd_scan against the JAX package's.

On the CPU the wrapper runs its plain version (the chunked algorithm in
fp32); the JAX side runs its Pallas kernel in interpret mode
(repro.kernels.ssd_scan, as tests/test_kernels.py runs it), its
sequential oracle ref.ssd_ref and the model's chunked form
models.ssm.ssd_chunked.  The same numpy inputs, at the JAX tests' scales,
go to all of them.  Tolerances: against the Pallas kernel and the oracle
the JAX tests' own, 2e-4 in fp32 and 6e-2 in bf16; against ssd_chunked,
which computes the same chunked sums in fp32, 1e-5 for y and the final
state.  The CUDA kernel itself is held against the plain version in
test_torch_cuda.py and chip_smoke.py.

``_bf16_kernel_model`` is a plain-PyTorch model of the bf16 CUDA kernel's
arithmetic (csrc/ssd_scan.cu, chunk TILE): chunk states from x·decay split
into a bf16 hi and lo pair against the exact bf16 B, the state pass in
the plain loop's order, and chunk outputs from C·Bᵀ of the bf16 inputs
(the decay as 2^((a_cum[i] − a_cum[j])·log2 e)), the masked scores and
the entering state each split the same way, y rounded once.  It is held against ssd_scan_plain and the interpret-mode
Pallas kernel within chip_smoke.py's gates (y within one bf16 ulp of max
|y| plus 1e-3, the state within 1e-4 relative and absolute), which shows
on the CPU that the gates hold for the algorithm; the same model without
the lo halves falls outside the state gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_scan as jax_ssd_scan
from repro.kernels.ref import ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import KERNELS, reset_launches
from repro_torch.kernels.ssd_scan import (NEG, TILE, ssd_scan,
                                          ssd_scan_plain)
from repro_torch.models import ssd_chunked

TOL = {torch.float32: 2e-4, torch.bfloat16: 6e-2}
CHUNKED_TOL = 1e-5
# chip_smoke.py's ssd_scan gates: the state within SSD_FP32_TOL relative
# and absolute, bf16 y within one bf16 ulp of max |y| plus SSD_BF16_ATOL
SSD_FP32_TOL = 1e-4
SSD_BF16_ATOL = 1e-3
BF16_ULP = 2.0 ** -7
LOG2E = float(np.float32(1.4426950408889634))
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (b, l, h, p, n, chunk): the JAX tests' shapes, then l = 1, 100 and 129
SHAPES = [(1, 64, 2, 16, 8, 32), (2, 128, 4, 32, 16, 64),
          (1, 96, 1, 8, 4, 32), (1, 256, 2, 64, 128, 128),
          (2, 1, 3, 16, 8, 32), (2, 100, 3, 16, 8, 32),
          (1, 129, 2, 32, 16, 64)]


def _inputs(b, l, h, p, n, seed):
    """x, a_dt, B, C at the JAX tests' scales (a_dt ≤ 0)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32) * 0.5,
            -np.abs(rng.normal(size=(b, l, h))).astype(np.float32) * 0.3,
            rng.normal(size=(b, l, h, n)).astype(np.float32) * 0.5,
            rng.normal(size=(b, l, h, n)).astype(np.float32) * 0.5)


def _torch(arrays, dtype):
    x, a, B, C = (torch.from_numpy(t) for t in arrays)
    return x.to(dtype), a, B.to(dtype), C.to(dtype)


def _jax(arrays, dtype):
    x, a, B, C = arrays
    return (jnp.asarray(x, JAX_DTYPE[dtype]), jnp.asarray(a),
            jnp.asarray(B, JAX_DTYPE[dtype]), jnp.asarray(C, JAX_DTYPE[dtype]))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES)
def test_ssd_scan_matches_jax(b, l, h, p, n, chunk, dtype):
    """The CPU wrapper (its plain version) against the interpret-mode
    Pallas kernel and the sequential oracle; no launch on the CPU."""
    arrays = _inputs(b, l, h, p, n, seed=l + n)
    args, jargs = _torch(arrays, dtype), _jax(arrays, dtype)
    reset_launches()
    got = ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == 0
    assert got.dtype == dtype and got.shape == (b, l, h, p)
    assert torch.equal(got, ssd_scan_plain(*args, chunk=chunk))
    _close(got, jax_ssd_scan(*jargs, chunk=chunk), TOL[dtype])
    _close(got, ssd_ref(*jargs), TOL[dtype])


@pytest.mark.parametrize("b,l,h,p,n,chunk,ref_chunk", [
    (1, 64, 2, 16, 8, 32, 32), (2, 128, 4, 32, 16, 64, 64),
    (1, 256, 2, 64, 128, 128, 128), (2, 1, 3, 16, 8, 32, 1),
    (2, 100, 3, 16, 8, 32, 50), (1, 129, 2, 32, 16, 64, 43)])
def test_return_state_matches_ssd_chunked(b, l, h, p, n, chunk, ref_chunk):
    """y and the fp32 final state against ssd_chunked's (y, final_state);
    a ragged l is padded by the wrapper and cut into ssd_chunked's
    divisor chunks on the JAX side, so the padded tail must leave the
    state exact."""
    arrays = _inputs(b, l, h, p, n, seed=2 * l + n)
    y, state = ssd_scan(*_torch(arrays, torch.float32), chunk=chunk,
                        return_state=True)
    want_y, want_state = jax_ssd_chunked(*_jax(arrays, torch.float32),
                                         chunk=ref_chunk)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    _close(y, want_y, CHUNKED_TOL)
    _close(state, want_state, CHUNKED_TOL)


def test_ssd_chunked_matches_jax_from_a_state():
    """The port's ssd_chunked, the reference's signature, from a nonzero
    init_state; it refuses a length that its chunk does not divide."""
    arrays = _inputs(2, 96, 3, 16, 8, seed=3)
    s0 = np.random.default_rng(4).normal(size=(2, 3, 16, 8)).astype(
        np.float32)
    y, state = ssd_chunked(*_torch(arrays, torch.float32), chunk=32,
                           init_state=torch.from_numpy(s0))
    want_y, want_state = jax_ssd_chunked(*_jax(arrays, torch.float32),
                                         chunk=32,
                                         init_state=jnp.asarray(s0))
    _close(y, want_y, CHUNKED_TOL)
    _close(state, want_state, CHUNKED_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_chunked(*_torch(arrays, torch.float32), chunk=40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_b_and_c_read_as_copies(dtype):
    """models/ssm.py passes B and C as head-broadcast views (head stride
    0); the result equals that of contiguous copies and the JAX kernel's
    on the broadcast arrays."""
    b, l, h, p, n = 2, 100, 4, 16, 8
    x, a, B, C = _inputs(b, l, h, p, n, seed=5)
    B1, C1 = B[:, :, :1, :], C[:, :, :1, :]
    tB = torch.from_numpy(B1).to(dtype).expand(b, l, h, n)
    tC = torch.from_numpy(C1).to(dtype).expand(b, l, h, n)
    assert tB.stride(2) == 0
    tx = torch.from_numpy(x).to(dtype)
    ta = torch.from_numpy(a)
    got, state = ssd_scan(tx, ta, tB, tC, chunk=32, return_state=True)
    want, want_state = ssd_scan(tx, ta, tB.contiguous(), tC.contiguous(),
                                chunk=32, return_state=True)
    assert torch.equal(got, want) and torch.equal(state, want_state)
    Bb, Cb = np.broadcast_to(B1, B.shape), np.broadcast_to(C1, C.shape)
    _close(got, jax_ssd_scan(*_jax((x, a, Bb, Cb), dtype), chunk=32),
           TOL[dtype])


GROUPED = [(2, 100, 8, 16, 8, 2, 32), (1, 129, 6, 8, 16, 3, 64),
           (2, 64, 4, 16, 8, 1, 32)]


def _grouped(b, l, h, p, n, g, seed):
    """x, a_dt and grouped B, C (b, l, g, n), and B, C expanded to the
    heads (head i reads group i // (h / g))."""
    x, a, _, _ = _inputs(b, l, h, p, n, seed)
    rng = np.random.default_rng(seed + 1)
    Bg = rng.normal(size=(b, l, g, n)).astype(np.float32) * 0.5
    Cg = rng.normal(size=(b, l, g, n)).astype(np.float32) * 0.5
    grouped = _torch((x, a, Bg, Cg), torch.float32)
    r = h // g
    expanded = grouped[:2] + tuple(t.repeat_interleave(r, 2)
                                   for t in grouped[2:])
    return grouped, expanded


@pytest.mark.parametrize("b,l,h,p,n,g,chunk", GROUPED)
def test_grouped_b_and_c_equal_the_expanded_heads(b, l, h, p, n, g, chunk):
    """B and C in g groups (Mamba2's n_groups) give the per-head call's y
    and final state, with each head reading its group, within 1e-6 of
    max |y| (C·Bᵀ taken once a group sums in another order); their
    gradients are the expanded call's summed over each group's heads."""
    grouped, expanded = _grouped(b, l, h, p, n, g, seed=11)
    y, state = ssd_scan(*grouped, chunk=chunk, return_state=True)
    want_y, want_state = ssd_scan(*expanded, chunk=chunk, return_state=True)
    torch.testing.assert_close(y, want_y, rtol=0,
                               atol=1e-6 * float(want_y.abs().max()))
    torch.testing.assert_close(state, want_state, rtol=0,
                               atol=1e-6 * float(want_state.abs().max()))
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))

    def grads(args):
        leaves = [t.clone().requires_grad_(True) for t in args]
        out = ssd_scan(*leaves, chunk=chunk)
        return torch.autograd.grad(out, leaves, gy)
    got, want = grads(grouped), grads(expanded)
    r = h // g
    want = want[:2] + tuple(w.reshape(b, l, g, r, n).sum(3)
                            for w in want[2:])
    for name, t, w in zip(("x", "a_dt", "B", "C"), got, want):
        assert t.shape == w.shape, name
        torch.testing.assert_close(t, w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=name)


def test_grouped_scan_under_vmap_equals_a_loop():
    """``_SSDScan``'s vmap rule folds the vmapped dim into the batch with
    grouped B and C too: the vmapped scan and its gradient equal the
    calls one by one."""
    from torch.func import grad, vmap
    grouped, _ = _grouped(3, 40, 4, 8, 8, 2, seed=12)

    def loss(x, a, B, C):
        return ssd_scan(x[None], a[None], B[None], C[None], chunk=16).sum()

    got = vmap(grad(loss, argnums=(0, 2, 3)))(*grouped)
    for i in range(3):
        want = grad(loss, argnums=(0, 2, 3))(*(t[i] for t in grouped))
        for t, w in zip(got, want):
            torch.testing.assert_close(t[i], w, rtol=1e-6, atol=1e-6)


def test_input_checks():
    x, a, B, C = _torch(_inputs(1, 8, 2, 4, 3, seed=0), torch.float32)
    with pytest.raises(ValueError, match="b, l, h, p"):
        ssd_scan(x[0], a, B, C)
    with pytest.raises(ValueError, match="a_dt must be"):
        ssd_scan(x, a[:, :4], B, C)
    with pytest.raises(ValueError, match="B and C must be"):
        ssd_scan(x, a, B, C[..., :2])
    with pytest.raises(ValueError, match="g dividing"):
        ssd_scan(x, a, B[:, :, :0], C[:, :, :0])
    with pytest.raises(ValueError, match="empty"):
        ssd_scan(x[..., :0], a, B, C)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x.half(), a, B.half(), C.half())
    with pytest.raises(TypeError, match="share a dtype"):
        ssd_scan(x, a, B.to(torch.bfloat16), C)
    with pytest.raises(TypeError, match="floating point"):
        ssd_scan(x, a.long(), B, C)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ssd_scan(x.to("meta"), a.to("meta"), B.to("meta"), C.to("meta"))
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(x, a, B, C, chunk=0)


def test_kernel_is_registered():
    assert ssd_scan in KERNELS
    ssd_scan.launches = 5
    reset_launches()
    assert ssd_scan.launches == 0


def _bf16_pair(v: torch.Tensor, split: bool = True):
    """fp32 v as the kernel feeds it to the tensor cores: hi = bf16(v) and
    lo = bf16(v - hi), as fp32 tensors (lo zero without ``split``)."""
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float() if split else torch.zeros_like(v)
    return hi, lo


def _bf16_kernel_model(x, a_dt, B, C, q: int = TILE, split: bool = True):
    """The bf16 kernel's three passes in plain PyTorch, at its chunk q: x,
    B and C bf16 (exact products), every other operand of a product an fp32
    value split into a bf16 pair, sums in fp32.  Returns (y in x's dtype,
    the fp32 final state)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    c = -(-l // q)
    pad = c * q - l
    xf, af, Bf, Cf = x.float(), a_dt.float(), B.float(), C.float()
    if pad:
        xf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                      for t in (xf, Bf, Cf))
        af = torch.nn.functional.pad(af, (0, 0, 0, pad))
    xc = xf.reshape(b, c, q, h, p)
    Bc = Bf.reshape(b, c, q, h, n)
    Cc = Cf.reshape(b, c, q, h, n)
    a_cum = torch.cumsum(af.reshape(b, c, q, h), dim=2)      # (b,c,q,h)

    # pass 1: S_c = (x · exp(a_cum[-1] − a_cum))ᵀ · B, the fp32 factor split
    xd = xc * torch.exp(a_cum[:, :, -1:] - a_cum)[..., None]
    hi, lo = _bf16_pair(xd, split)
    chunk_states = (torch.einsum("bcqhp,bcqhn->bchpn", hi, Bc)
                    + torch.einsum("bcqhp,bcqhn->bchpn", lo, Bc))
    chunk_decay = torch.exp(a_cum[:, :, -1])                 # (b,c,h)

    # pass 2: the plain version's loop
    state = torch.zeros((b, h, p, n), dtype=torch.float32)
    entering = []
    for ci in range(c):
        entering.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_states[:, ci]
    entering = torch.stack(entering, dim=1)                  # (b,c,h,p,n)

    # pass 3: exp(a_cum)·(C·enteringᵀ), then + ((C·Bᵀ) ⊙ L)·x
    e_hi, e_lo = _bf16_pair(entering, split)
    y = (torch.einsum("bcqhn,bchpn->bcqhp", Cc, e_hi)
         + torch.einsum("bcqhn,bchpn->bcqhp", Cc, e_lo))
    y = y * torch.exp(a_cum)[..., None]
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (b,c,i,j,h)
    mask = torch.ones((q, q), dtype=torch.bool).tril()[None, None, :, :, None]
    # the kernel takes the decay as 2^((a_cum[i] − a_cum[j])·log2 e)
    L = torch.exp2(torch.where(mask, seg, NEG) * LOG2E)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * L
    s_hi, s_lo = _bf16_pair(scores, split)
    y = y + (torch.einsum("bcijh,bcjhp->bcihp", s_hi, xc)
             + torch.einsum("bcijh,bcjhp->bcihp", s_lo, xc))
    return y.reshape(b, c * q, h, p)[:, :l].to(x.dtype), state


def _within_gates(y, state, want_y, want_state) -> bool:
    """chip_smoke.py's gates on a bf16 call (check_ssd_scan)."""
    y_atol = BF16_ULP * float(want_y.float().abs().max()) + SSD_BF16_ATOL
    y_ok = bool(((y.float() - want_y.float()).abs() <= y_atol).all())
    state_ok = bool(((state - want_state).abs()
                     <= SSD_FP32_TOL + SSD_FP32_TOL * want_state.abs()).all())
    return y_ok and state_ok


# (b, l, h, p, n, broadcast): ragged l (a partial last chunk, and l under
# one chunk), p 16 and 40, n 8 and 100, head-broadcast and per-head B/C,
# b = 1
MODEL_CASES = [(1, 300, 2, 16, 8, True), (2, 200, 3, 40, 100, False),
               (1, 100, 2, 40, 8, False), (1, 257, 2, 16, 100, True)]


def _model_inputs(b, l, h, p, n, broadcast, seed):
    x, a, B, C = _inputs(b, l, h, p, n, seed)
    if broadcast:
        B = np.broadcast_to(B[:, :, :1], B.shape)
        C = np.broadcast_to(C[:, :, :1], C.shape)
    return x, a, np.ascontiguousarray(B), np.ascontiguousarray(C)


@pytest.mark.parametrize("b,l,h,p,n,broadcast", MODEL_CASES)
def test_bf16_kernel_model_within_the_gates(b, l, h, p, n, broadcast):
    """The model of the bf16 kernel's arithmetic against ssd_scan_plain
    (y and state) and the interpret-mode Pallas kernel (y), within
    chip_smoke.py's gates; without the lo halves the state leaves them."""
    arrays = _model_inputs(b, l, h, p, n, broadcast, seed=7 * l + n)
    args = _torch(arrays, torch.bfloat16)
    y, state = _bf16_kernel_model(*args)
    want_y, want_state = ssd_scan_plain(*args, chunk=TILE, return_state=True)
    assert y.dtype == torch.bfloat16 and y.shape == (b, l, h, p)
    assert _within_gates(y, state, want_y, want_state)
    pallas = torch.from_numpy(np.asarray(
        jax_ssd_scan(*_jax(arrays, torch.bfloat16), chunk=TILE), np.float32))
    y_atol = BF16_ULP * float(pallas.abs().max()) + SSD_BF16_ATOL
    assert float((y.float() - pallas).abs().max()) <= y_atol
    y_lo, state_lo = _bf16_kernel_model(*args, split=False)
    assert not _within_gates(y_lo, state_lo, want_y, want_state)


# ------------------------------------------------------------ the backward
# The gates of the backward on the card (test_torch_cuda.py, chip_smoke.py):
# against the plain version's VJP, fp32 grads within SSD_FP32_TOL of each
# input's max |grad|; bf16 grads within one bf16 ulp of each element plus
# SSD_FP32_TOL of the max (bf16 inputs: both sides compute the fp32 VJP
# to far under a bf16 ulp and round it once, where the roundings may fall
# an ulp apart; fp32 inputs, split on load to 16 significant bits, err by
# about 1e-5 of max |grad|, which SSD_FP32_TOL's 1e-4 holds).
def _parts(t: torch.Tensor, split: bool = True):
    """An input operand as the backward kernels feed it to the tensor
    cores: bf16 as it is, fp32 as a hi and lo pair."""
    t32 = t.float()
    return _bf16_pair(t32, split) if t.dtype == torch.float32 else (t32,)


def _mm(eq: str, a, b):
    """The sum of the einsum over every pair of parts, lo × lo left out."""
    out = 0
    for i, u in enumerate(a):
        for j, v in enumerate(b):
            if not (i and j):
                out = out + torch.einsum(eq, u, v)
    return out


def _backward_kernel_model(x, a_dt, B, C, gy, gstate=None, q: int = TILE,
                           split: bool = True):
    """The backward kernels' four passes (csrc/ssd_scan.cu, "Backward") in
    plain PyTorch at their chunk q: every fp32 operand of a product split
    into a bf16 pair (fp32 inputs too), sums in fp32, the score decay as
    2^((a_cum[i] − a_cum[j])·log2 e), each a_cum cotangent gathered as the
    kernels gather it (rows from pass 3, columns and the chunk's last
    position from pass 4), da the reverse cumulative sum over the chunk.
    Returns (dx, da_dt, dB, dC) in the inputs' dtypes, B and C's grads
    summed over each group's heads before the rounding."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    r = h // g
    c = -(-l // q)
    pad = c * q - l

    def padded(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t
    X = _parts(padded(x).reshape(b, c, q, h, p), split)
    GY = _parts(padded(gy).reshape(b, c, q, h, p), split)
    Bc = _parts(padded(B.repeat_interleave(r, 2)).reshape(b, c, q, h, n), split)
    Cc = _parts(padded(C.repeat_interleave(r, 2)).reshape(b, c, q, h, n), split)
    xs, gys, Cs = sum(X), sum(GY), sum(Cc)
    af = a_dt.float()
    if pad:
        af = torch.nn.functional.pad(af, (0, 0, 0, pad))
    A = torch.cumsum(af.reshape(b, c, q, h), dim=2)           # (b,c,q,h)
    d_out = torch.exp(A[:, :, -1:] - A)
    e_a = torch.exp(A)
    decay = torch.exp(A[:, :, -1])                            # (b,c,h)

    # pass 1: each chunk's own state and the state cotangent its y gives
    S = _mm("bcqhp,bcqhn->bchpn", _bf16_pair(xs * d_out[..., None], split),
            Bc)
    Gam = _mm("bcqhp,bcqhn->bchpn", _bf16_pair(gys * e_a[..., None], split),
              Cc)
    # pass 2: the entering states forward, the handed-on cotangents back
    state, entering = torch.zeros((b, h, p, n)), []
    for ci in range(c):
        entering.append(state)
        state = state * decay[:, ci, :, None, None] + S[:, ci]
    entering = torch.stack(entering, dim=1)                   # (b,c,h,p,n)
    g_out = [None] * c
    cot = torch.zeros((b, h, p, n)) if gstate is None else gstate.float()
    for ci in reversed(range(c)):
        g_out[ci] = cot
        cot = cot * decay[:, ci, :, None, None] + Gam[:, ci]
    g_out = torch.stack(g_out, dim=1)

    mask = torch.ones((q, q), dtype=torch.bool).tril()[None, None, :, :, None]
    seg = A[:, :, :, None, :] - A[:, :, None, :, :]           # (b,c,i,j,h)
    L = torch.where(mask, torch.exp2(torch.where(mask, seg, 0.0) * LOG2E),
                    0.0)
    scores = _mm("bcihn,bcjhn->bcijh", Cc, Bc)
    gx = _mm("bcihp,bcjhp->bcijh", GY, X)
    below = torch.ones((q, q), dtype=torch.bool).tril(-1)
    dseg = torch.where(below[None, None, :, :, None], gx * scores * L, 0.0)

    # pass 3: rows i
    dC = (_mm("bcihp,bchpn->bcihn", GY, _bf16_pair(entering, split))
          * e_a[..., None])
    row = dseg.sum(3) + (Cs * dC).sum(-1)                     # (b,c,i,h)
    dC = dC + _mm("bcijh,bcjhn->bcihn", _bf16_pair(gx * L, split), Bc)
    # pass 4: rows j, then da
    g_pair = _bf16_pair(g_out, split)
    dx = _mm("bcjhn,bchpn->bcjhp", Bc, g_pair) * d_out[..., None]
    f = (xs * dx).sum(-1)                                     # (b,c,j,h)
    dB = _mm("bcjhp,bchpn->bcjhn", X, g_pair) * d_out[..., None]
    dx = dx + _mm("bcijh,bcihp->bcjhp", _bf16_pair(scores * L, split), GY)
    dB = dB + _mm("bcijh,bcihn->bcjhn", _bf16_pair(gx * L, split), Cc)
    dA = row - dseg.sum(2) - f
    dA[:, :, -1] += f.sum(2) + decay * (g_out * entering).sum((-1, -2))
    da = dA.flip(2).cumsum(2).flip(2)

    def grouped(t):
        return t.reshape(b, c * q, g, r, n).sum(3)[:, :l].to(B.dtype)
    return (dx.reshape(b, c * q, h, p)[:, :l].to(x.dtype),
            da.reshape(b, c * q, h)[:, :l].to(a_dt.dtype),
            grouped(dB), grouped(dC))


def _within_grad_gates(got, want) -> bool:
    """The backward's card gates (above) on (dx, da_dt, dB, dC)."""
    for t, w in zip(got, want):
        assert t.dtype == w.dtype and t.shape == w.shape
        w32 = w.float()
        atol = SSD_FP32_TOL * float(w32.abs().max())
        tol = atol + (BF16_ULP * w32.abs() if w.dtype == torch.bfloat16
                      else 0.0)
        if not bool(((t.float() - w32).abs() <= tol).all()):
            return False
    return True


def _plain_grads(x, a, B, C, gy, gstate=None):
    """torch.func.vjp of ssd_scan_plain at the kernels' chunk."""
    (_, state), vjp = torch.func.vjp(
        lambda *args: ssd_scan_plain(*args, TILE, return_state=True),
        x, a, B, C)
    return vjp((gy, torch.zeros_like(state) if gstate is None else gstate))


def _jax_grads(x, a, B, C, gy, gstate=None):
    """jax.vjp of the JAX package's ssd_chunked in fp32 on the same values
    (B and C expanded to the heads, their grads summed over each group's
    heads), at a chunk dividing l, each grad rounded once to its input's
    dtype."""
    import jax
    b, l, h, p = x.shape
    r = h // B.shape[2]
    chunk = max(d for d in range(1, TILE + 1) if l % d == 0)
    chunk = chunk if chunk >= 32 else l
    arrays = [jnp.asarray(t.float().numpy()) for t in
              (x, a, B.repeat_interleave(r, 2), C.repeat_interleave(r, 2))]
    (_, state), vjp = jax.vjp(
        lambda *args: jax_ssd_chunked(*args, chunk=chunk), *arrays)
    cot = (np.zeros(state.shape, np.float32) if gstate is None
           else gstate.numpy())
    gx, ga, gB, gC = (torch.from_numpy(np.array(t, np.float32)) for t in
                      vjp((jnp.asarray(gy.float().numpy()),
                           jnp.asarray(cot))))
    gB, gC = (t.reshape(b, l, -1, r, t.shape[-1]).sum(3) for t in (gB, gC))
    return (gx.to(x.dtype), ga.to(a.dtype), gB.to(B.dtype), gC.to(C.dtype))


def _backward_inputs(b, l, h, p, n, broadcast, g, dtype, seed):
    """x, a_dt, B, C (grouped when g, else per head, head-broadcast when
    broadcast) in dtype, the cotangent gy in dtype and an fp32 gstate."""
    if g:
        (x, a, B, C), _ = _grouped(b, l, h, p, n, g, seed)
    else:
        x, a, B, C = (torch.from_numpy(t) for t in
                      _model_inputs(b, l, h, p, n, broadcast, seed))
    rng = np.random.default_rng(seed + 2)
    gy = torch.from_numpy(rng.normal(size=(b, l, h, p)).astype(np.float32))
    gstate = torch.from_numpy(rng.normal(size=(b, h, p, n)).astype(
        np.float32))
    return (x.to(dtype), a, B.to(dtype), C.to(dtype), gy.to(dtype)), gstate


# (b, l, h, p, n, broadcast, g): MODEL_CASES per head, then grouped B/C
# at g = 2 and g = h / 2
BACKWARD_CASES = [(*case, None) for case in MODEL_CASES] + [
    (2, 200, 4, 16, 8, False, 2), (1, 300, 6, 40, 100, False, 3),
    (1, 257, 8, 16, 36, False, 2), (1, 129, 8, 16, 8, False, 4)]


@pytest.mark.parametrize("with_gstate", [False, True])
@pytest.mark.parametrize("b,l,h,p,n,broadcast,g", BACKWARD_CASES)
def test_backward_kernel_model_within_the_grad_gates(b, l, h, p, n,
                                                     broadcast, g,
                                                     with_gstate):
    """The model of the backward kernels' arithmetic, bf16 inputs, against
    torch.func.vjp of ssd_scan_plain and jax.vjp of the JAX package's
    ssd_chunked, within the card's grad gates, with the final state's
    cotangent given or not; grouped B and C get (b, l, g, n) grads."""
    (x, a, B, C, gy), gstate = _backward_inputs(
        b, l, h, p, n, broadcast, g, torch.bfloat16, seed=5 * l + n)
    gstate = gstate if with_gstate else None
    got = _backward_kernel_model(x, a, B, C, gy, gstate)
    assert got[2].shape == B.shape and got[3].shape == C.shape
    assert _within_grad_gates(got, _plain_grads(x, a, B, C, gy, gstate))
    assert _within_grad_gates(got, _jax_grads(x, a, B, C, gy, gstate))


@pytest.mark.parametrize("b,l,h,p,n,broadcast,g", [
    (2, 200, 3, 40, 100, False, None), (1, 300, 6, 40, 100, False, 3)])
def test_backward_kernel_model_in_fp32_within_the_grad_gates(b, l, h, p, n,
                                                             broadcast, g):
    """fp32 inputs through the same passes, x, B, C and gy split on load
    as well: within SSD_FP32_TOL of each max |grad| of the plain VJP."""
    (x, a, B, C, gy), gstate = _backward_inputs(
        b, l, h, p, n, broadcast, g, torch.float32, seed=l + n)
    got = _backward_kernel_model(x, a, B, C, gy, gstate)
    assert _within_grad_gates(got, _plain_grads(x, a, B, C, gy, gstate))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,l,h,p,n,broadcast,g", [
    (2, 200, 3, 40, 100, False, None), (1, 257, 8, 16, 36, False, 2)])
def test_backward_kernel_model_without_lo_halves_leaves_the_gates(
        b, l, h, p, n, broadcast, g, dtype):
    """The same model with the lo halves dropped (every fp32 operand a
    single bf16) falls outside the grad gates: the splits are what hold
    the products to fp32's precision."""
    (x, a, B, C, gy), gstate = _backward_inputs(
        b, l, h, p, n, broadcast, g, dtype, seed=3 * l + n)
    got = _backward_kernel_model(x, a, B, C, gy, gstate, split=False)
    assert not _within_grad_gates(got, _plain_grads(x, a, B, C, gy, gstate))


@pytest.mark.parametrize("p_past", [1, 64])
def test_card_backward_refuses_head_dims_past_its_tile(monkeypatch, p_past):
    """The card's backward takes p up to BACKWARD_MAX_P (one tile): on its
    path (``_kernel_backward``, forced here on the CPU) a larger p raises
    ValueError naming the limit before any launch, with no plain VJP
    standing in; the CPU's own path differentiates any p."""
    import importlib
    module = importlib.import_module("repro_torch.kernels.ssd_scan")
    b, l, h, n = 1, 20, 2, 8
    p = module.BACKWARD_MAX_P + p_past
    gen = torch.Generator().manual_seed(p)
    x = torch.randn((b, l, h, p), generator=gen, requires_grad=True)
    a = -torch.rand((b, l, h), generator=gen)
    B, C = (torch.randn((b, l, 1, n), generator=gen) for _ in range(2))
    y = ssd_scan(x, a, B, C)
    (dx,) = torch.autograd.grad(y.sum(), x, retain_graph=True)
    assert dx.shape == x.shape and bool(torch.isfinite(dx).all())
    monkeypatch.setattr(module, "_kernel_backward", lambda t: True)
    launches = ssd_scan.backward_launches
    with pytest.raises(ValueError, match=f"up to {module.BACKWARD_MAX_P}, "
                                         f"got {p}"):
        torch.autograd.grad(y.sum(), x)
    assert ssd_scan.backward_launches == launches


def test_kernel_backward_path_folds_under_vmap(monkeypatch):
    """The path the card takes under autograd (``_SSDScanBackward``), on
    the CPU with the model standing in for the kernels: one call a
    backward, inside the ``ssd_scan_plain_backward`` span; under
    vmap(grad) one folded call, equal to the calls one by one, and within
    the grad gates of the plain version's."""
    import importlib

    from torch.func import grad, vmap
    module = importlib.import_module("repro_torch.kernels.ssd_scan")
    calls = []

    def kernels(*args):
        calls.append(tuple(args[0].shape))
        return _backward_kernel_model(*args)
    monkeypatch.setattr(module, "_kernel_backward", lambda x: True)
    monkeypatch.setattr(module, "_scan_backward", kernels)
    grouped, _ = _grouped(3, 140, 4, 8, 8, 2, seed=12)

    def loss(x, a, B, C):
        y, state = ssd_scan(x[None], a[None], B[None], C[None],
                            return_state=True)
        return y.sum() + (state * state).sum()

    argnums = (0, 1, 2, 3)
    got = vmap(grad(loss, argnums=argnums))(*grouped)
    assert calls == [(3, 140, 4, 8)]
    with torch.profiler.profile() as prof:
        want = grad(loss, argnums=argnums)(*(t[0] for t in grouped))
    assert len(calls) == 2
    assert any(e.name == "ssd_scan_plain_backward" for e in prof.events())
    monkeypatch.undo()
    for i in range(3):
        one = grad(loss, argnums=argnums)(*(t[i] for t in grouped))
        if i == 0:
            for t, w in zip(want, one):
                assert _within_grad_gates((t,), (w,))
        for t, w in zip(got, one):
            assert _within_grad_gates((t[i],), (w,))
