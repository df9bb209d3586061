"""The port's fed_agg / fed_agg_apply against the JAX package's kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, as tests/test_kernels.py does, and
its jnp oracles.  The same numpy inputs go to both.  The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import APPLY_OPTS as JAX_APPLY_OPTS
from repro.kernels import fed_agg as jax_fed_agg
from repro.kernels import fed_agg_apply as jax_fed_agg_apply
from repro.kernels.ref import fed_agg_ref
from repro_torch.kernels.fed_agg import APPLY_OPTS, fed_agg, fed_agg_apply

HYPER = (0.1, 0.8, 0.9, 0.99, 1e-3)          # lr, mix, b1, b2, eps
BF16_ULP = 2.0 ** -7                          # bf16 keeps 8 significant bits


def _inputs(K, P, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(K, P)).astype(np.float32),
            rng.random(K).astype(np.float32))


def _sum_bound(u, c, rtol):
    """rtol of Σ_k |c_k·U[k, p]|: the scale an fp32 sum's rounding error
    follows, whatever order the K terms are added in."""
    return rtol * np.abs(c[:, None] * u).sum(axis=0)


@pytest.mark.parametrize("K", [1, 3, 12])
@pytest.mark.parametrize("P", [1, 2047, 2048, 5000])
def test_fed_agg_fp32_matches_jax(K, P):
    u, c = _inputs(K, P)
    got = fed_agg(torch.from_numpy(u), torch.from_numpy(c)).numpy()
    bound = _sum_bound(u, c, 1e-6)
    for want in (jax_fed_agg(jnp.asarray(u), jnp.asarray(c)),
                 fed_agg_ref(jnp.asarray(u), jnp.asarray(c))):
        want = np.asarray(want)
        assert got.dtype == want.dtype == np.float32
        assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("K", [1, 3, 12])
@pytest.mark.parametrize("P", [1, 2047, 2048, 5000])
def test_fed_agg_bf16_matches_jax(K, P):
    u, c = _inputs(K, P, seed=1)
    u_t = torch.from_numpy(u).to(torch.bfloat16)
    got = fed_agg(u_t, torch.from_numpy(c))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    u_j = jnp.asarray(u, jnp.bfloat16)
    u_exact = np.asarray(u_j, np.float32)
    # one bf16 ulp of the result, on top of the fp32 sum's rounding
    for want in (jax_fed_agg(u_j, jnp.asarray(c)),
                 fed_agg_ref(u_j, jnp.asarray(c))):
        want = np.asarray(want, np.float32)
        tol = (BF16_ULP * np.maximum(np.abs(got), np.abs(want))
               + _sum_bound(u_exact, c, 1e-6))
        assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("opt", APPLY_OPTS)
def test_fed_agg_apply_matches_jax(opt):
    assert APPLY_OPTS == JAX_APPLY_OPTS
    K, P = 7, 3001
    u, c = _inputs(K, P, seed=2)
    rng = np.random.default_rng(3)
    g = rng.normal(size=P).astype(np.float32)
    m = (rng.normal(size=P) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=P)) * 0.1).astype(np.float32)
    arrays = (u, c, g, m, v)
    want = jax_fed_agg_apply(*(jnp.asarray(a) for a in arrays), *HYPER,
                             opt=opt)
    got = fed_agg_apply(*(torch.from_numpy(a) for a in arrays), *HYPER,
                        opt=opt)
    names = ("out", "m", "v", "update_norm")
    for name, w, t in zip(names, want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_fed_agg_eq3_identical_updates():
    """Eq. 3 coefficients summing to 1 over identical rows give the row."""
    w = np.random.default_rng(4).normal(size=256).astype(np.float32)
    u = torch.from_numpy(np.stack([w, w, w]))
    c = torch.tensor([0.5, 0.3, 0.2])
    np.testing.assert_allclose(fed_agg(u, c).numpy(), w, rtol=1e-6)


def test_wrappers_reject_bad_inputs():
    u = torch.zeros(3, 10)
    c = torch.ones(3)
    vec = torch.zeros(10)
    with pytest.raises(TypeError):
        fed_agg(u.double(), c)                      # dtype of updates
    with pytest.raises(TypeError):
        fed_agg(u, c.double())                      # dtype of coeffs
    with pytest.raises(TypeError):
        fed_agg(u, torch.ones(4))                   # K mismatch
    with pytest.raises(ValueError):
        fed_agg(torch.zeros(30), c)                 # not (K, P)
    with pytest.raises(ValueError):
        fed_agg(torch.zeros(10, 3).t(), c)          # not contiguous
    with pytest.raises(ValueError):
        fed_agg(u.to("meta"), c.to("meta"))         # neither cpu nor cuda
    with pytest.raises(TypeError):
        fed_agg_apply(u, c, torch.zeros(9), vec, vec, *HYPER)
    with pytest.raises(ValueError):
        fed_agg_apply(u.to("meta"), c.to("meta"), vec.to("meta"),
                      vec.to("meta"), vec.to("meta"), *HYPER)
    with pytest.raises(ValueError):
        fed_agg_apply(u, c, vec, vec, vec, *HYPER, opt="lamb")


def test_cpu_calls_do_not_count_launches():
    before = (fed_agg.launches, fed_agg_apply.launches)
    u, c = torch.ones(2, 5), torch.ones(2)
    fed_agg(u, c)
    fed_agg_apply(u, c, torch.ones(5), torch.zeros(5), torch.zeros(5),
                  *HYPER)
    assert (fed_agg.launches, fed_agg_apply.launches) == before
