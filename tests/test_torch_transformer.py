"""The port's transformer serving path against the JAX package's.

Params come from the JAX package's ``init_params`` and are carried into
the port with ``convert.params_from_numpy``; inputs are made with numpy
from a seed and handed to both.  The reduced configs compute in fp32.
Layers agree within 1e-6; logits of forward, prefill and decode within
1e-4, caches likewise, and greedy tokens exactly, on both attention paths
(``use_pallas_attention``: the JAX Pallas kernel in interpret mode against
the port's kernel wrapper, which runs its plain version on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_architectures as jax_list_architectures
from repro.models import config as jax_config
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models.attention import self_attention as jax_self_attention
from repro_torch.configs import PORT_ONLY, get_config, list_architectures
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import flash_attention, reset_launches
from repro_torch.launch.serve import generate
from repro_torch.models import forward, init_cache, init_params, param_count
from repro_torch.models import layers
from repro_torch.models.attention import self_attention
from torch_parity_common import (LAYER_TOL, LOGIT_TOL, check_serving_path,
                                 close as _close, port as _port,
                                 np_tree as _np_tree,
                                 tree_close as _tree_close)

# the configs with MoE or cross blocks (tests/test_torch_moe.py,
# tests/test_torch_vlm.py)
MOE_AND_CROSS = ("arctic-480b", "llama-3.2-vision-11b",
                 "llama4-maverick-400b-a17b")


# ------------------------------------------------------------- configs
def _shared_fields(cfg) -> dict:
    """The config's fields that the JAX package's ArchConfig has; the
    port's own fields must sit at their defaults."""
    ours = dataclasses.asdict(cfg)
    jax_fields = {f.name for f in dataclasses.fields(jax_config.ArchConfig)}
    defaults = {f.name: f.default for f in dataclasses.fields(cfg)}
    assert {k: v for k, v in ours.items() if k not in jax_fields} == \
        {k: defaults[k] for k in ours if k not in jax_fields}, cfg.name
    return {k: v for k, v in ours.items() if k in jax_fields}


def test_architectures_and_configs_match():
    """The JAX registry plus the port-only configs (``PORT_ONLY``); each
    shared config equal to the reference's, field for field, the port's
    own fields at their defaults."""
    assert list_architectures() == sorted(jax_list_architectures()
                                          + list(PORT_ONLY))
    for arch in jax_list_architectures():
        mine, ref = get_config(arch), jax_get_config(arch)
        assert _shared_fields(mine) == dataclasses.asdict(ref), arch
        assert param_count(mine) == jax_config.param_count(ref), arch
        assert (_shared_fields(mine.reduced())
                == dataclasses.asdict(ref.reduced())), arch
    assert param_count(get_config("gemma2-2b")) == 2_614_222_080
    # Nemotron 3 Nano 30B-A3B: 31.6B parameters (the analytic count, which
    # leaves out the Mamba conv bias, as the reference's count does)
    assert param_count(get_config("nemotron-3-nano-30b-a3b")) == \
        31_577_798_976


@pytest.mark.parametrize("arch", MOE_AND_CROSS)
def test_moe_and_cross_init_matches_reference(arch):
    """init_params of the reduced MoE and VLM configs: the reference's
    keys, shapes and dtypes (the MoE router and the cross gate in fp32),
    and the param count (the analytic one plus one ``xgate`` a cross
    block, which it leaves out)."""
    cfg = get_config(arch).reduced()
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax_init_params(jax_get_config(arch).reduced(),
                          jax.random.PRNGKey(0))
    spec = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  _np_tree(ref))
    assert jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), params_to_numpy(mine)) == spec
    n_cross = cfg.n_super * cfg.pattern.count("cross")
    assert (sum(t.numel() for t in jax.tree_util.tree_leaves(mine))
            == param_count(cfg) + n_cross)


def test_init_params_tree_matches_reference():
    """Random init from a torch.Generator: the reference's keys, shapes
    and dtypes, stacked blocks included, and He-scaled spreads."""
    cfg = get_config("gemma2-2b").reduced().replace(n_layers=5)
    mine = init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax_init_params(jax_get_config("gemma2-2b").reduced()
                          .replace(n_layers=5), jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                    _np_tree(ref))
    assert jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), params_to_numpy(mine)) == shapes
    wq = mine["blocks"]["pos0"]["attn"]["wq"]
    assert abs(float(wq.std()) - (2.0 / cfg.d_model) ** 0.5) < 0.01
    assert abs(float(mine["embed"].std()) - 0.02) < 0.002


# ------------------------------------------------------------- layers
def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
           LAYER_TOL)
    pos = np.arange(7)[None, :].repeat(2, 0)
    for fraction in (1.0, 0.5):
        _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 fraction, 10000.0),
               jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     fraction, 10000.0), LAYER_TOL)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    mlp = {n: rng.normal(size=s).astype(np.float32) * 0.3
           for n, s in (("wg", (16, 24)), ("wu", (16, 24)), ("wd", (24, 16)))}
    for act in ("silu", "gelu"):
        _close(layers.gated_mlp(params_from_numpy(mlp, "cpu"),
                                torch.from_numpy(h), act),
               jax_layers.gated_mlp(mlp, jnp.asarray(h), act), LAYER_TOL)
    logits = (rng.normal(size=(3, 50)) * 40).astype(np.float32)
    t_logits = torch.from_numpy(logits)
    _close(layers.softcap(t_logits, 30.0),
           jax_layers.softcap(jnp.asarray(logits), 30.0), LAYER_TOL)
    assert layers.softcap(t_logits, 0.0) is t_logits


@pytest.mark.parametrize("branch", ["kernel", "single", "chunked"])
def test_self_attention_branches_match(branch):
    """The three branches of self_attention (the kernel, S <= q_chunk,
    and the query-chunked loop with q_chunk 16) on reduced gemma2-2b at
    S = 80 > window 64, local and global."""
    jcfg = jax_get_config("gemma2-2b").reduced()
    cfg = get_config("gemma2-2b").reduced()
    if branch == "kernel":
        jcfg = jcfg.replace(use_pallas_attention=True)
        cfg = cfg.replace(use_pallas_attention=True)
    q_chunk = 16 if branch == "chunked" else 1024
    ref_params = jax_init_params(jcfg, jax.random.PRNGKey(3))
    p_jax = jax.tree_util.tree_map(lambda a: a[0],
                                   ref_params["blocks"]["pos0"]["attn"])
    p = _port(p_jax)
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 80, cfg.d_model)) * 0.5).astype(np.float32)
    pos = np.arange(80)[None, :].repeat(2, 0)
    reset_launches()
    for window in (cfg.window, None):
        got, (k, v) = self_attention(p, torch.from_numpy(x),
                                     torch.from_numpy(pos), cfg, window,
                                     q_chunk=q_chunk, return_kv=True)
        want, (jk, jv) = jax_self_attention(p_jax, jnp.asarray(x),
                                            jnp.asarray(pos), jcfg, window,
                                            q_chunk=q_chunk, return_kv=True)
        _close(got, want, LOGIT_TOL)
        _close(k, jk, LAYER_TOL)
        _close(v, jv, LAYER_TOL)
    assert flash_attention.launches == 0


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", ["gemma2-2b", "chatglm3-6b", "gemma3-1b",
                                  "internlm2-20b"])
def test_serving_path_matches(arch, pallas):
    """forward, prefill (logits and every cache leaf), 4 decode steps
    (logits and caches) and generate's 8 greedy tokens.  gemma2-2b's and
    gemma3-1b's prompts of 80 exceed their reduced window of 64, so the
    local layers' ring buffers wrap (gemma3-1b: 11 local and 2 global
    blocks in one superblock); chatglm3-6b has GQA group 2, half-dim RoPE
    and an untied head; internlm2-20b GQA and RoPE theta 1e6."""
    check_serving_path(arch, pallas,
                       80 if arch in ("gemma2-2b", "gemma3-1b") else 40)


def test_remainder_layers_and_init_cache():
    """n_layers = 3 on a period-2 pattern: one stacked superblock and an
    unrolled remainder; init_cache's tree matches the reference's."""
    from repro.models import init_cache as jax_init_cache
    jcfg = jax_get_config("gemma2-2b").reduced().replace(n_layers=3)
    cfg = get_config("gemma2-2b").reduced().replace(n_layers=3)
    ref_params = jax_init_params(jcfg, jax.random.PRNGKey(5))
    assert "rem" in ref_params
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (1, 24))
    _close(forward(cfg, _port(ref_params),
                   {"tokens": torch.from_numpy(tokens)}),
           jax_forward(jcfg, ref_params,
                       {"tokens": jnp.asarray(tokens, jnp.int32)}),
           LOGIT_TOL)
    _tree_close(init_cache(cfg, 2, 100, torch.float32),
                jax_init_cache(jcfg, 2, 100, jnp.float32), 0.0)


def test_generate_samples_with_temperature():
    cfg = get_config("gemma2-2b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 10),
                           generator=torch.Generator().manual_seed(1))
    a = generate(cfg, params, prompt, 5, temperature=1.0,
                 generator=torch.Generator().manual_seed(2))
    b = generate(cfg, params, prompt, 5, temperature=1.0,
                 generator=torch.Generator().manual_seed(2))
    assert a.tokens.shape == (2, 5)
    assert torch.equal(a.tokens, b.tokens)
    assert int(a.tokens.min()) >= 0 and int(a.tokens.max()) < cfg.vocab
