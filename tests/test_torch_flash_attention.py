"""The port's flash_attention against the JAX package's.

On the CPU the wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode (repro.kernels.flash_attention, bq = bk =
64 as its own tests run it) and its jnp oracle ref.flash_attention_ref.
The same numpy inputs go to all three.  Tolerances are the JAX tests' own
(tests/test_kernels.py: 2e-5 in fp32, 4e-2 in bf16).  The CUDA kernel
itself is held against the plain version in test_torch_cuda.py and
chip_smoke.py.  A tiled model of the bf16 kernel's arithmetic (p rounded
to bf16 per tile) is held here against both, within the bound that
rounding implies (``bf16_bound``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import KERNELS, reset_launches
from repro_torch.kernels.flash_attention import (MIN_L, NEG, bf16_bound,
                                                 check_kernel_layout,
                                                 flash_attention,
                                                 flash_attention_plain)

TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(B, H, Hkv, S, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, S, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, d)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, d)).astype(np.float32))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _check_all(arrays, dtype, **kw):
    """Plain version and CPU wrapper against the interpret-mode Pallas
    kernel and the jnp oracle; the wrapper launches nothing on the CPU."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    jq, jk, jv = (jnp.asarray(a, JAX_DTYPE[dtype]) for a in arrays)
    reset_launches()
    got = flash_attention(q, k, v, **kw)
    plain = flash_attention_plain(q, k, v, **kw)
    assert flash_attention.launches == 0
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, plain)
    tol = TOL[dtype]
    _close(got, jax_flash(jq, jk, jv, bq=64, bk=64, **kw), tol)
    _close(got, flash_attention_ref(jq, jk, jv, **kw), tol)
    return got


@pytest.mark.parametrize("B,H,Hkv,S,d", [
    (1, 2, 2, 128, 32), (2, 4, 2, 256, 64), (1, 8, 1, 192, 32),
    (1, 2, 2, 100, 16),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_jax(B, H, Hkv, S, d, dtype):
    _check_all(_inputs(B, H, Hkv, S, d, seed=S + d), dtype)


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_window(window):
    _check_all(_inputs(1, 2, 2, 160, 32, seed=window), torch.float32,
               window=window)


def test_flash_attention_softcap_window_gqa():
    """Gemma 2's combination: softcap, a window and GQA, ragged S."""
    _check_all(_inputs(2, 4, 2, 100, 32, seed=7), torch.float32,
               window=32, softcap=20.0)
    _check_all(_inputs(1, 2, 1, 77, 16, seed=8), torch.float32,
               softcap=20.0)


def test_flash_attention_not_causal():
    _check_all(_inputs(1, 2, 1, 70, 16, seed=9), torch.float32,
               causal=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_one_step(dtype):
    """S = 1: the one row attends to itself, so the output is v."""
    q, k, v = _inputs(2, 4, 2, 1, 32, seed=11)
    got = _check_all((q, k, v), dtype, window=64, softcap=50.0)
    want = torch.from_numpy(v).to(dtype).repeat_interleave(2, dim=1)
    assert torch.equal(got, want)


def test_window_none_and_zero_are_global():
    arrays = _inputs(1, 2, 2, 90, 16, seed=12)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    base = flash_attention(q, k, v)
    assert torch.equal(flash_attention(q, k, v, window=0), base)
    assert torch.equal(flash_attention(q, k, v, window=None), base)
    assert not torch.equal(flash_attention(q, k, v, window=8), base)


def test_strided_views_read_as_contiguous():
    """models/attention.py hands over (B, S, H, d) buffers as swapaxes
    views; the result equals that of contiguous copies."""
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.normal(size=(2, 50, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 50, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 50, 2, 16)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = flash_attention(*views, window=20, softcap=30.0)
    want = flash_attention(*(t.contiguous() for t in views), window=20,
                           softcap=30.0)
    assert torch.equal(got, want)


def test_input_checks():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 3, 2, 8, 16, 0))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, 8, 16, 0))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="share a dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="B, H, S, d"):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="k and v must be"):
        flash_attention(q, k[:, :, :4], v[:, :, :4])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="softcap"):
        flash_attention(q, k, v, softcap=-1.0)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_kernel_is_registered():
    assert flash_attention in KERNELS
    flash_attention.launches = 5
    reset_launches()
    assert flash_attention.launches == 0


def _tiled_bf16_model(q, k, v, causal=True, window=None, softcap=0.0,
                      tile=64, drop=None):
    """What the bf16 kernel computes, in plain PyTorch: query and kv tiles
    of ``tile`` rows, the fp32 score scaled after the product, capped and
    masked, the online softmax in fp32, p rounded to bf16 for p·v tile by
    tile and l summed from the fp32 p.  With ``tile`` >= S it is the plain
    version with p rounded to bf16.  ``drop`` names a kv tile to leave out,
    as a broken kernel would."""
    B, H, S, d = q.shape
    group = H // k.shape[1]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    out = torch.empty((B, H, S, d))
    for q0 in range(0, S, tile):
        rows = torch.arange(q0, min(q0 + tile, S))
        m = torch.full((B, H, len(rows), 1), NEG)
        l = torch.zeros((B, H, len(rows), 1))
        acc = torch.zeros((B, H, len(rows), d))
        for k0 in range(0, S, tile):
            if drop is not None and k0 == drop * tile:
                continue
            cols = torch.arange(k0, min(k0 + tile, S))
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
                 * (1.0 / d ** 0.5))
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            mask = torch.ones((len(rows), len(cols)), dtype=torch.bool)
            if causal:
                mask &= rows[:, None] >= cols[None, :]
            if window:
                mask &= (rows[:, None] - cols[None, :]) < window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = alpha * acc + p.to(torch.bfloat16).float() @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=MIN_L)
    return out.to(q.dtype)


def _err_over_bound(got, want, bound) -> float:
    """max |got - want| / bound: at most 1 within the bound."""
    err = (got.float() - want.float()).abs()
    return float((err / bound.clamp(min=torch.finfo(torch.float32).tiny))
                 .max())


@pytest.mark.parametrize("B,H,Hkv,S,d,window,softcap,causal", [
    (1, 2, 2, 100, 16, None, 0.0, True),      # ragged S, d padded to 64
    (1, 4, 2, 130, 64, None, 50.0, True),     # GQA, softcap
    (2, 2, 1, 129, 128, 32, 0.0, True),       # GQA, window
    (1, 2, 2, 70, 256, None, 50.0, True),     # Gemma 2's head dim
    (1, 2, 1, 150, 64, 48, 20.0, True),       # window and softcap
    (1, 2, 2, 90, 64, None, 0.0, False),      # not causal
])
def test_bf16_kernel_arithmetic_within_its_bound(B, H, Hkv, S, d, window,
                                                 softcap, causal):
    """The tiled model of the bf16 kernel against the plain version and the
    interpret-mode Pallas kernel on the same bf16 inputs, within
    bf16_bound: rounding p to bf16 moves each output by at most 2⁻⁸ of its
    row's Σp|v|/l, plus the two outputs' own bf16 rounding."""
    arrays = _inputs(B, H, Hkv, S, d, seed=S + d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = _tiled_bf16_model(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    bound = bf16_bound(q, k, v, want, **kw)
    assert _err_over_bound(got, want, bound) <= 1.0
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    pallas = torch.from_numpy(np.asarray(
        jax_flash(jq, jk, jv, bq=64, bk=64, **kw), np.float32))
    assert _err_over_bound(got, pallas, bf16_bound(q, k, v, pallas, **kw)) <= 1.0
    # the rounding of p is what the bound is for: the plain version with
    # p rounded alike (one tile over all of S) stays within it too
    assert _err_over_bound(_tiled_bf16_model(q, k, v, **kw, tile=S), want,
                           bound) <= 1.0


def test_bf16_bound_catches_a_dropped_kv_tile():
    """The bound is tight enough to see a kernel that skips one 64-row kv
    tile in rows of up to 1024 keys (36 times over at this seed), while the
    right arithmetic stays inside it on the same inputs."""
    arrays = _inputs(1, 2, 1, 1024, 64, seed=11)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    want = flash_attention_plain(q, k, v)
    bound = bf16_bound(q, k, v, want)
    assert _err_over_bound(_tiled_bf16_model(q, k, v), want, bound) <= 1.0
    assert _err_over_bound(_tiled_bf16_model(q, k, v, drop=8), want,
                           bound) > 1.0


def test_bf16_bound_formula():
    """One key: p = 1 and l = 1, so A = |v| and the bound is
    2⁻⁷·|want| + (2⁻⁸ + 2⁻¹¹)·|v| element by element; a row that attends
    only small values gets a small bound."""
    q = torch.ones((1, 1, 1, 4), dtype=torch.bfloat16)
    v = torch.tensor([[[[1.0, -4.0, 0.0, 0.5]]]], dtype=torch.bfloat16)
    want = flash_attention_plain(q, q, v)
    assert torch.equal(want, v)
    want_bound = (2.0 ** -7 + 2.0 ** -8 + 2.0 ** -11) * v.float().abs()
    assert torch.equal(bf16_bound(q, q, v, want), want_bound)
    # two keys, the second far more likely: row 1's bound follows its
    # weights, not the largest |v|
    q = torch.tensor([[[[0.0], [16.0]]]], dtype=torch.bfloat16)
    k = torch.tensor([[[[0.0], [16.0]]]], dtype=torch.bfloat16)
    v = torch.tensor([[[[100.0], [0.01]]]], dtype=torch.bfloat16)
    want = flash_attention_plain(q, k, v)
    bound = bf16_bound(q, k, v, want)
    assert float(bound[0, 0, 1, 0]) < 1e-3 < 100.0 * 2.0 ** -8


def test_kernel_layout_accepts_what_the_model_passes():
    """Contiguous tensors and the model's swapaxes views of (B, S, H, d)
    buffers meet the bf16 kernel's alignment; a dim of size 1 may have any
    stride; fp32 takes any batch, head and time strides."""
    bf16 = torch.bfloat16
    q = torch.zeros(2, 4, 16, 64, dtype=bf16)
    check_kernel_layout(q, q[:, :2], q[:, :2])
    view = torch.zeros(2, 16, 4, 64, dtype=bf16).transpose(1, 2)
    check_kernel_layout(view, view, view)
    one = torch.zeros(1, 1, 1, 12, dtype=bf16)[..., :4]
    check_kernel_layout(one, one, one)
    odd = torch.zeros(1, 2, 16, 12)[..., :4]
    check_kernel_layout(odd, odd, odd)


def test_kernel_layout_refusals():
    """What the card's kernels cannot read in place raises before any
    launch, and nothing is copied: a bf16 start off 16 bytes, a bf16 time
    stride that is not a multiple of 8, a head dim above 256 or one that is
    not contiguous."""
    bf16 = torch.bfloat16
    n = 2 * 4 * 16 * 64
    flat = torch.zeros(n + 8, dtype=bf16)
    assert flat.data_ptr() % 16 == 0
    shifted = flat[1:1 + n].view(2, 4, 16, 64)
    good = torch.zeros(2, 4, 16, 64, dtype=bf16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_kernel_layout(shifted, good, good)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_kernel_layout(good, good, shifted)
    wide = torch.zeros(1, 2, 16, 12, dtype=bf16)[..., :4]
    with pytest.raises(ValueError, match="multiples of 8"):
        check_kernel_layout(wide, wide, wide)
    big = torch.zeros(1, 1, 4, 320)
    with pytest.raises(ValueError, match="up to 256"):
        check_kernel_layout(big, big, big)
    strided = torch.zeros(1, 1, 4, 128)[..., ::2]
    with pytest.raises(ValueError, match="contiguous in the head dim"):
        check_kernel_layout(strided, strided, strided)
