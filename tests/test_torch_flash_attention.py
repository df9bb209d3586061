"""The port's flash_attention against the JAX package's.

On the CPU the wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode (repro.kernels.flash_attention, bq = bk =
64 as its own tests run it) and its jnp oracle ref.flash_attention_ref.
The same numpy inputs go to all three.  Tolerances are the JAX tests' own
(tests/test_kernels.py: 2e-5 in fp32, 4e-2 in bf16).  The CUDA kernel
itself is held against the plain version in test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels.ref import flash_attention_ref
from repro_torch.kernels import KERNELS, reset_launches
from repro_torch.kernels.flash_attention import (flash_attention,
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
