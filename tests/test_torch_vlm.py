"""The port's cross attention and the VLM (llama-3.2-vision-11b) against
the JAX package's.

Params come from the JAX package's ``init_params`` (every cross block's
``xgate`` set to XGATE in the numpy tree, so tanh(xgate) does not zero the
cross path), image embeddings and tokens from numpy with a seed; both
packages get the same.  The reduced config computes in fp32: the layers
within LAYER_TOL-scale 1e-5, logits within LOGIT_TOL = 1e-4
(tests/torch_parity_common.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attention
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import prefill as jax_prefill
from repro.models import warm_cross_caches as jax_warm_cross_caches
from repro_torch.configs import get_config
from repro_torch.models import (forward, init_cache, init_params,
                                param_count, prefill, warm_cross_caches)
from repro_torch.models import attention
from torch_parity_common import (LOGIT_TOL, XGATE, check_loss_and_grads,
                                 check_serving_path, close, image_embeds,
                                 port, tree_close, zoo_params)

ARCH = "llama-3.2-vision-11b"
CROSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU models gain nothing from intra-op threads, and with one
    the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tree = zoo_params(jcfg)
    return jcfg, cfg, tree, jax.tree_util.tree_map(jnp.asarray, tree)


def test_cross_attention_and_its_cache_match():
    """cross_attention, init_cross_cache and decode_cross_attention of one
    cross block's ``xattn`` params (GQA 4 q / 4 KV heads reduced, so also
    a grouped case) on 16 patches."""
    jcfg, cfg, tree, _ = _setup()
    for n_kv in (cfg.n_kv_heads, 2):
        jc, c = jcfg.replace(n_kv_heads=n_kv), cfg.replace(n_kv_heads=n_kv)
        p_np = {k: np.asarray(v[0]) for k, v in
                zoo_params(jc)["blocks"]["pos4"]["xattn"].items()}
        p = port(p_np)
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 9, c.d_model)).astype(np.float32)
        feats = image_embeds(c)
        close(attention.cross_attention(p, torch.from_numpy(x),
                                        torch.from_numpy(feats), c),
              jax_attention.cross_attention(p_np, jnp.asarray(x),
                                            jnp.asarray(feats), jc),
              CROSS_TOL)
        for dtype, jdtype in ((torch.float32, jnp.float32),
                              (torch.bfloat16, jnp.bfloat16)):
            cc = attention.init_cross_cache(p, torch.from_numpy(feats),
                                            dtype)
            want = jax_attention.init_cross_cache(p_np, jnp.asarray(feats),
                                                  jdtype)
            assert cc["ck"].dtype == dtype
            close(cc["ck"], want["ck"], CROSS_TOL)
            close(cc["cv"], want["cv"], CROSS_TOL)
        cc = attention.init_cross_cache(p, torch.from_numpy(feats),
                                        torch.float32)
        close(attention.decode_cross_attention(p, torch.from_numpy(x[:, :1]),
                                               cc, c),
              jax_attention.decode_cross_attention(
                  p_np, jnp.asarray(x[:, :1]),
                  {k: jnp.asarray(v.numpy()) for k, v in cc.items()}, jc),
              CROSS_TOL)


def test_init_cache_and_warm_cross_caches_match():
    """init_cache holds zero ck/cv of (B, n_patches, K, hd) in each cross
    block; warm_cross_caches fills them as the reference does, and equals
    what prefill with the embeddings leaves there."""
    jcfg, cfg, tree, ref_params = _setup()
    feats = image_embeds(cfg)
    want = jax_warm_cross_caches(jcfg, ref_params,
                                 jax_init_cache(jcfg, 2, 30, jnp.float32),
                                 jnp.asarray(feats))
    params = port(tree)
    cache = init_cache(cfg, 2, 30, torch.float32)
    assert cache["blocks"]["pos4"]["ck"].shape == (1, 2, cfg.n_patches,
                                                   cfg.n_kv_heads, cfg.hd)
    warm = warm_cross_caches(cfg, params, cache, torch.from_numpy(feats))
    tree_close(warm, want, CROSS_TOL)
    assert not bool(cache["blocks"]["pos4"]["ck"].any())  # a new tree
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    _, pre = prefill(cfg, params, {"tokens": torch.from_numpy(tokens),
                                   "image_embeds": torch.from_numpy(feats)},
                     cache_len=30, cache_dtype=torch.float32)
    for key in ("ck", "cv"):
        assert torch.equal(pre["blocks"]["pos4"][key],
                           warm["blocks"]["pos4"][key])


def test_without_image_embeds_cross_is_skipped():
    """As in the reference: without embeddings forward skips the cross
    attention (so xgate does not matter) and prefill's cross blocks emit
    no ck/cv."""
    jcfg, cfg, tree, ref_params = _setup()
    params = port(tree)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    close(forward(cfg, params, {"tokens": torch.from_numpy(tokens)}),
          jax_forward(jcfg, ref_params,
                      {"tokens": jnp.asarray(tokens, jnp.int32)}),
          LOGIT_TOL)
    _, cache = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    _, jcache = jax_prefill(jcfg, ref_params,
                            {"tokens": jnp.asarray(tokens, jnp.int32)})
    assert set(cache["blocks"]["pos4"]) == set(jcache["blocks"]["pos4"]) \
        == {"k", "v"}


def test_gate_opens_the_cross_path():
    """With xgate at XGATE the logits depend on the embeddings; at init's
    zero they do not."""
    _, cfg, tree, _ = _setup()
    params = port(tree)
    assert float(params["blocks"]["pos4"]["xgate"][0, 0]) == np.float32(
        XGATE)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)))
    feats = torch.from_numpy(image_embeds(cfg))
    a = forward(cfg, params, {"tokens": tokens, "image_embeds": feats})
    b = forward(cfg, params, {"tokens": tokens,
                              "image_embeds": torch.zeros_like(feats)})
    assert float((a - b).abs().max()) > 1e-3
    params["blocks"]["pos4"]["xgate"].zero_()
    a = forward(cfg, params, {"tokens": tokens, "image_embeds": feats})
    b = forward(cfg, params, {"tokens": tokens,
                              "image_embeds": torch.zeros_like(feats)})
    assert torch.equal(a, b)


def test_param_count_with_the_gates():
    """The analytic count of llama-3.2-vision-11b at full width, and
    init_params at a cut size: the count plus one ``xgate`` a cross block,
    which the reference's analytic count leaves out (as the JAX package's
    own init_params holds it)."""
    from repro.models import init_params as jax_init_params
    from repro.models.config import param_count as jax_param_count

    cfg = get_config(ARCH)
    assert param_count(cfg) == 10_110_734_336
    small = cfg.replace(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
                        d_ff=96, vocab=128, n_patches=8)
    params = init_params(small, torch.Generator().manual_seed(0))
    n_cross = 2
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(params)) \
        == param_count(small) + n_cross
    jsmall = jax_get_config(ARCH).replace(
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab=128, n_patches=8)
    assert sum(a.size for a in jax.tree_util.tree_leaves(jax_init_params(
        jsmall, jax.random.PRNGKey(0)))) == jax_param_count(jsmall) + n_cross
    assert params["blocks"]["pos4"]["xgate"].dtype == torch.float32


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "kernel"])
def test_vlm_serving_path_matches(pallas):
    """forward, prefill (its cache's ck/cv included), 4 decode steps and 8
    greedy tokens with 16 patch embeddings and the gates open."""
    check_serving_path(ARCH, pallas, 40)


@pytest.mark.parametrize("efficient_ce", [False, True])
def test_vlm_loss_and_grads_match_reference(efficient_ce):
    """loss_fn with image embeddings and every grad, xattn and xgate
    included, against jax.value_and_grad."""
    check_loss_and_grads(ARCH, efficient_ce)
