"""The port's Mamba2 block and the hybrid serving path against the JAX
package's.

Block params come from the JAX package's ``mamba_init`` (model params from
its ``init_params``) and are carried into the port with
``convert.params_from_numpy``; inputs are made with numpy from a seed and
handed to both.  Everything is fp32 on the CPU, where the block's scan
runs in ``ssd_scan``'s plain version, so the block, its cache and a decode
step agree within 1e-5 (the chunked sums are taken in another order);
whole models within LOGIT_TOL = 1e-4, as the dense archs in
test_torch_transformer.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.convert import params_to_numpy
from repro_torch.core.flatten import tree_leaves
from repro_torch.kernels import reset_launches, ssd_scan
from repro_torch.models import (init_cache, init_mamba_cache, init_params,
                                mamba_block, mamba_decode_step, param_count)
from torch_parity_common import (check_serving_path, close, np_tree, port,
                                 tree_close)

BLOCK_TOL = 1e-5


def _block(seed):
    """Reduced mamba2-130m's config for both packages and one block's
    params from the JAX package's init, carried into the port."""
    jcfg = jax_get_config("mamba2-130m").reduced()
    cfg = get_config("mamba2-130m").reduced()
    jp = jax_ssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, port(jp)


def _x(cfg, S, seed):
    return (np.random.default_rng(seed).normal(size=(2, S, cfg.d_model))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("S", [1, 2, 40, 130])
def test_mamba_block_and_its_cache_match(S):
    """The block's output and prefill cache {"conv", "ssm"}; S = 1 and 2
    are shorter than the conv's K - 1 = 3 (the padded tail), S = 130 runs
    in the reference's chunk of 65."""
    jcfg, cfg, jp, p = _block(S)
    x = _x(cfg, S, seed=S + 1)
    reset_launches()
    out, cache = mamba_block(p, torch.from_numpy(x), cfg, return_cache=True)
    want, want_cache = jax_ssm.mamba_block(jp, jnp.asarray(x), jcfg,
                                           return_cache=True)
    assert ssd_scan.launches == 0
    close(out, want, BLOCK_TOL)
    tree_close(cache, want_cache, BLOCK_TOL)
    assert all(t.dtype == torch.float32 for t in cache.values())
    close(mamba_block(p, torch.from_numpy(x), cfg), want, BLOCK_TOL)


def test_mamba_decode_step_matches_and_writes_in_place():
    jcfg, cfg, jp, p = _block(7)
    x = _x(cfg, 1, seed=8)
    rng = np.random.default_rng(9)
    cache_np = {k: rng.normal(size=v.shape).astype(np.float32) * 0.3
                for k, v in params_to_numpy(init_mamba_cache(cfg, 2))
                .items()}
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    conv, ssm = cache["conv"], cache["ssm"]
    out, new = mamba_decode_step(p, torch.from_numpy(x), cache, cfg)
    want, want_new = jax_ssm.mamba_decode_step(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache_np.items()},
        jcfg)
    close(out, want, BLOCK_TOL)
    tree_close(new, want_new, BLOCK_TOL)
    assert new["conv"] is conv and new["ssm"] is ssm


@pytest.mark.parametrize("S", [2, 12, 129])
def test_prefill_cache_continues_decode(S):
    """Prefill of S tokens, then one decode step, equals the full
    sequence of S + 1 at its last position (the kernel's final state
    against the recurrence)."""
    _, cfg, _, p = _block(10)
    x = torch.from_numpy(_x(cfg, S + 1, seed=11))
    full = mamba_block(p, x, cfg)[:, -1]
    _, cache = mamba_block(p, x[:, :S], cfg, return_cache=True)
    dec, _ = mamba_decode_step(p, x[:, S:S + 1], cache, cfg)
    torch.testing.assert_close(dec[:, 0], full, rtol=BLOCK_TOL,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("arch,pallas,long_context", [
    ("mamba2-130m", False, False), ("zamba2-1.2b", False, False),
    ("zamba2-1.2b", True, False), ("zamba2-1.2b", True, True)],
    ids=["mamba2-130m", "zamba2-1.2b-plain", "zamba2-1.2b-kernel",
         "zamba2-1.2b-long-context"])
def test_serving_path_matches(arch, pallas, long_context):
    """forward, prefill (logits and every cache leaf: conv windows, SSM
    states, the shared block's KV stacked per superblock), 4 decode steps
    and generate's 8 greedy tokens.  The long-context variant gives the
    shared attention block a window of 64 under a prompt of 80, so its
    ring buffer wraps."""
    check_serving_path(arch, pallas, 80 if long_context else 40,
                       long_context=long_context)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_init_params_and_cache_trees_match_reference(arch):
    """Random init from a torch.Generator: the reference's keys, shapes
    and dtypes (one weight-tied shared block, no params at its pattern
    position), param_count's total plus the conv biases it leaves out,
    and the reference's spreads; init_cache's tree equals the reference's."""
    cfg = get_config(arch).reduced()
    jcfg = jax_get_config(arch).reduced()
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax_init_params(jcfg, jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                    np_tree(ref))
    assert jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), params_to_numpy(mine)) == shapes
    assert ("shared_attn" in mine) == (arch == "zamba2-1.2b")
    # the reference's analytic count leaves out each Mamba block's conv_b
    conv_b = cfg.n_layers * (cfg.d_inner + 2 * cfg.ssm_state)
    assert sum(t.numel() for t in tree_leaves(mine)) == (param_count(cfg)
                                                         + conv_b)
    m = mine["blocks"]["pos0"]["mamba"]
    assert abs(float(m["in_proj"].std()) - (2.0 / cfg.d_model) ** 0.5) < 0.01
    A = torch.exp(m["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) <= 16.0
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    tree_close(init_cache(cfg, 2, 100, torch.float32),
               jax_init_cache(jcfg, 2, 100, jnp.float32), 0.0)
