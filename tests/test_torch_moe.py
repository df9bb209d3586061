"""The port's mixture-of-experts block against the JAX package's.

Router logits, params and activations are made with numpy from a seed
(params by the JAX package's ``moe_init``) and handed to both packages.
Tolerances:

- ``_dispatch_combine``: the dispatch tensor (which token sits in which
  expert slot, drops included) equal, element for element.  The combine
  tensor has the same support and, for top-1 (weight p / p = 1), equal
  values; for top-2 its weights p_i / (p_1 + p_2) are within 2 fp32 ulp
  (rtol 2.4e-7): XLA's and PyTorch's ``exp`` differ in the last bit on
  about a tenth of their inputs, and the softmax's sum is reduced in
  another order, so equal bits are out of reach for any softmax of the
  port's own.
- ``moe_block``: within 1e-5 (fp32 sums in another order); ``router_load``
  equal.
- Ties go to the lowest expert index, as ``jax.lax.top_k`` breaks them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import config as jax_config
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import forward, init_params, param_count
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig
from torch_parity_common import (LOGIT_TOL, check_loss_and_grads,
                                 check_serving_path, close, np_tree)

MOE_TOL = 1e-5
COMBINE_RTOL = 2.4e-7                 # 2 ulp of fp32 (see the module doc)
MOE_ARCHS = ("arctic-480b", "llama4-maverick-400b-a17b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU models gain nothing from intra-op threads, and with one
    the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**kw):
    base = dict(name="t", arch_type="moe", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, d_ff=48, vocab=64, n_experts=4,
                top_k=2, moe_group_size=16, capacity_factor=8.0,
                dtype="float32")
    base.update(kw)
    return jax_config.ArchConfig(**base), ArchConfig(**base)


def _logits(g, E, seed, pad=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(g, E)) * 2).astype(np.float32)
    if pad:
        x[-pad:] = 0.0          # moe_block's padded rows: every prob ties
    return x


def _check_dispatch_combine(logits, k, C):
    want_d, want_c = map(np.asarray, jax_moe._dispatch_combine(
        jnp.asarray(logits), k, C))
    got_d, got_c = (t.numpy() for t in moe._dispatch_combine(
        torch.from_numpy(logits), k, C))
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c != 0, want_c != 0)
    if k == 1:
        np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_allclose(got_c, want_c, rtol=COMBINE_RTOL, atol=0)
    return want_d


@pytest.mark.parametrize("g,E,k,C,pad", [
    (64, 4, 2, 40, 0),          # drop-free (.reduced()'s factor 8)
    (37, 8, 2, 5, 9),           # drops, and tied padded rows
    (100, 128, 1, 3, 0),        # top-1 over the full-width 128 experts
    (300, 128, 2, 6, 44),       # top-2 over 128 with drops and padding
])
def test_dispatch_combine_matches_reference(g, E, k, C, pad):
    dispatch = _check_dispatch_combine(_logits(g, E, g, pad), k, C)
    # every slot holds at most one token and no token exceeds k slots
    assert dispatch.sum(axis=0).max() <= 1
    assert dispatch.sum(axis=(1, 2)).max() <= k


def test_dispatch_with_explicit_ties():
    """Integer logits with repeated values: tied probs within a row, so
    the order of the top-k and the slots it fills depend on the tie
    rule alone."""
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 3, size=(48, 6)).astype(np.float32)
    logits[:5] = 1.0            # rows tied across all experts
    for k, C in ((1, 4), (2, 6), (2, 100)):
        _check_dispatch_combine(logits, k, C)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = moe._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_i[0].tolist() == [0, 1, 2]


def test_capacity_matches_reference():
    for group in (1, 2, 39, 64, 4096):
        for k, E, f in ((1, 128, 1.25), (2, 128, 1.25), (2, 4, 8.0),
                        (1, 4, 0.5)):
            assert (moe._capacity(group, k, E, f)
                    == jax_moe._capacity(group, k, E, f))
    # the full-width configs at B = 2 × 2048: one group of 4096
    assert moe._capacity(4096, 1, 128, 1.25) == 40
    assert moe._capacity(4096, 2, 128, 1.25) == 80
    assert moe._capacity(2, 1, 128, 1.25) == 1      # a decode step


@pytest.mark.parametrize("setting", ["drop_free", "drops_ragged",
                                     "parallel_dense", "gelu_top1"])
def test_moe_block_matches_reference(setting):
    """moe_block and router_load: drop-free; capacity 1.25 with top-2 and
    T = 39 tokens in groups of 16 (the last padded with 9 zero rows, whose
    probs tie, so tokens drop); a parallel dense MLP (arctic); and top-1
    with GeGLU experts (llama4's routing)."""
    kw = {"drop_free": {},
          "drops_ragged": dict(capacity_factor=1.25),
          "parallel_dense": dict(parallel_dense_mlp=True,
                                 capacity_factor=1.25),
          "gelu_top1": dict(top_k=1, act="gelu", capacity_factor=1.25)}
    jcfg, cfg = _cfg(**kw[setting])
    p_np = np_tree(jax_moe.moe_init(jax.random.PRNGKey(3), jcfg))
    p = params_from_numpy(p_np, device="cpu")
    B, S = (3, 13)
    x = np.random.default_rng(4).normal(size=(B, S, 32)).astype(np.float32)
    want = jax_moe.moe_block(p_np, jnp.asarray(x), jcfg)
    got = moe.moe_block(p, torch.from_numpy(x), cfg)
    close(got, want, MOE_TOL)
    load = moe.router_load(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(
        load.numpy(), np.asarray(jax_moe.router_load(p_np, jnp.asarray(x),
                                                     jcfg)))
    assert int(load.sum()) == B * S * cfg.top_k
    if setting != "drop_free":
        # these settings drop (token, choice) pairs
        assert _kept_pairs(p, x, cfg) < B * S * cfg.top_k


def _kept_pairs(p, x, cfg) -> int:
    """(token, choice) pairs of x's real tokens that moe_block keeps."""
    T, g = x.shape[0] * x.shape[1], cfg.moe_group_size
    flat = torch.from_numpy(x).reshape(T, -1)
    flat = torch.cat([flat, torch.zeros((-T % g, flat.shape[1]))])
    C = moe._capacity(g, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    kept = 0
    for start in range(0, T, g):
        dispatch, _ = moe._dispatch_combine(
            flat[start:start + g] @ p["router"], cfg.top_k, C)
        kept += int(dispatch[:T - start].sum())
    return kept


def test_moe_init_tree_matches_reference():
    """moe_init's keys, shapes and dtypes (the router in fp32 whatever the
    param dtype) equal the reference's, with and without the dense MLP."""
    for dense in (False, True):
        jcfg, cfg = _cfg(parallel_dense_mlp=dense)
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            mine = params_to_numpy(moe.moe_init(torch.Generator(), cfg,
                                                dtype))
            ref = np_tree(jax_moe.moe_init(jax.random.PRNGKey(0), jcfg,
                                           jdtype))
            spec = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                          ref)
            assert jax.tree_util.tree_map(
                lambda a: (a.shape, str(a.dtype)), mine) == spec
            assert mine["router"].dtype == np.float32


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_serving_path_matches(arch, pallas):
    """Reduced arctic-480b (top-2, parallel dense MLP) and llama4 (top-1,
    MoE every other layer): forward, prefill, decode and greedy tokens
    (tests/torch_parity_common.check_serving_path); 2 × 40 tokens make
    two groups of 64, the second padded."""
    check_serving_path(arch, pallas, 40)


@pytest.mark.parametrize("efficient_ce", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_grads_match_reference(arch, efficient_ce):
    check_loss_and_grads(arch, efficient_ce)


def test_bf16_params_cross_bit_for_bit():
    """A reduced arctic-480b tree at param_dtype bfloat16 (the router stays
    fp32) goes from JAX to the port and back bit for bit; the forward on
    it (fp32 activations) matches the reference's within LOGIT_TOL."""
    from repro.models import forward as jax_forward
    from repro.models import init_params as jax_init_params

    jcfg = jax_get_config("arctic-480b").reduced().replace(
        param_dtype="bfloat16")
    cfg = get_config("arctic-480b").reduced().replace(param_dtype="bfloat16")
    ref = np_tree(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(ref, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert params["blocks"]["pos0"]["moe"]["router"].dtype == torch.float32
    back = params_to_numpy(params)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree_util.tree_leaves(back)):
        assert g.dtype == w.dtype, path
        assert g.tobytes() == w.tobytes(), path
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    close(forward(cfg, params, {"tokens": torch.from_numpy(tokens)}),
          jax_forward(jcfg, jax.tree_util.tree_map(jnp.asarray, ref),
                      {"tokens": jnp.asarray(tokens, jnp.int32)}),
          LOGIT_TOL)
    # init_params makes the same tree in bf16, and meets the param count
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                   params_to_numpy(mine))
            == jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                      ref))
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(
        mine)) == param_count(cfg)
