"""Helpers shared by the port's parity tests of the model zoo: params and
caches carried from the JAX package into the port, tree comparisons, and
the serving path (forward, prefill, decode, greedy generate) held against
the JAX package's on a reduced config.

Params come from the JAX package's ``init_params`` and are carried into
the port with ``convert.params_from_numpy``; inputs are made with numpy
from a seed and handed to both.  The reduced configs compute in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.flatten import tree_paths
from repro_torch.kernels import KERNELS, reset_launches
from repro_torch.launch.serve import generate
from repro_torch.models import (decode_step, forward, grads_of, loss_fn,
                                prefill)

LAYER_TOL = 1e-6
LOGIT_TOL = 1e-4
# training: the loss within LOSS_RTOL relative and every leaf's gradient
# within GRAD_REL_L2 relative L2 of the JAX package's (fp32 rounding
# through two to seven reduced blocks; 7.2e-6 the largest measured on
# the CPU)
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port(tree):
    return params_from_numpy(np_tree(tree), device="cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def tree_close(got, want, tol):
    got_np = params_to_numpy(got)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(np_tree(want))
    for path, w in flat_w:
        g = got_np
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))
    assert (sorted(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.shape, np_tree(want))))
        == sorted(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            np.shape, got_np))))


def jax_generate(cfg, params, prompt, new):
    """examples/serve_decode.py's greedy loop: the prefill logits and
    cache, every decode step's (tokens, pos, logits, cache), and the
    generated ids (B, new).  A codebook model's prompt is (B, n_cb, S); it
    picks from the first codebook's logits and feeds every codebook."""
    S = prompt.shape[-1]
    logits, cache = jax_prefill(cfg, params, {"tokens": prompt},
                                cache_len=S + new, cache_dtype=jnp.float32)
    step = jax.jit(lambda p, c, t, pos: jax_decode_step(cfg, p, c, t, pos))
    steps, ids = [], []
    tok = prompt[..., -1:]
    for i in range(new):
        pos = jnp.full((prompt.shape[0],), S + i, jnp.int32)
        step_logits, step_cache = step(params, cache if i == 0
                                       else steps[-1][3], tok, pos)
        steps.append((tok, pos, step_logits, step_cache))
        nxt = jnp.argmax(step_logits[:, -1, :cfg.vocab], axis=-1)
        ids.append(np.asarray(nxt))
        tok = (jnp.broadcast_to(nxt[:, None, None],
                                (prompt.shape[0], cfg.n_codebooks, 1))
               if cfg.n_codebooks else nxt[:, None]).astype(jnp.int32)
    return logits, cache, steps, np.stack(ids, axis=1)


def check_serving_path(arch: str, pallas: bool, S: int, new: int = 8,
                       long_context: bool = False):
    """forward, prefill (logits and every cache leaf), 4 decode steps
    (logits and caches) and generate's ``new`` greedy tokens of reduced
    ``arch`` (its ``.long_context()`` variant if asked) on a (2, S)
    prompt ((2, n_cb, S) for codebooks), against the JAX package within
    LOGIT_TOL; no kernel launches on the CPU."""
    jcfg = jax_get_config(arch).reduced().replace(
        use_pallas_attention=pallas)
    cfg = get_config(arch).reduced().replace(use_pallas_attention=pallas)
    if long_context:
        jcfg, cfg = jcfg.long_context(), cfg.long_context()
    ref_params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = port(ref_params)
    shape = (2, cfg.n_codebooks, S) if cfg.n_codebooks else (2, S)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, shape)
    jprompt = jnp.asarray(prompt, jnp.int32)
    tprompt = torch.from_numpy(prompt)

    close(forward(cfg, params, {"tokens": tprompt}),
          jax_forward(jcfg, ref_params, {"tokens": jprompt}), LOGIT_TOL)

    want_logits, want_cache, steps, want_ids = jax_generate(
        jcfg, ref_params, jprompt, new)
    logits, cache = prefill(cfg, params, {"tokens": tprompt},
                            cache_len=S + new, cache_dtype=torch.float32)
    close(logits, want_logits, LOGIT_TOL)
    # the reference's cache tree, stacked blocks and all, carries over
    carried = params_from_numpy(np_tree(want_cache), device="cpu")
    tree_close(cache, want_cache, LOGIT_TOL)
    tree_close(carried, want_cache, 0.0)
    for tok, pos, want_step, want_step_cache in steps[:4]:
        step_logits, cache = decode_step(
            cfg, params, cache, torch.from_numpy(np.array(tok)),
            torch.from_numpy(np.array(pos)))
        close(step_logits, want_step, LOGIT_TOL)
        tree_close(cache, want_step_cache, LOGIT_TOL)

    reset_launches()
    out = generate(cfg, params, tprompt, new)
    np.testing.assert_array_equal(out.tokens.numpy(), want_ids)
    close(out.prefill_logits, want_logits, LOGIT_TOL)
    assert all(k.launches == 0 for k in KERNELS)   # no kernel on the CPU


def lm_batch(cfg, B=2, S=32, seed=1):
    """Token and label ids of (B, S), or (B, n_cb, S) for codebooks, from
    a seed, as numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    return {"tokens": rng.integers(0, cfg.vocab, shape),
            "labels": rng.integers(0, cfg.vocab, shape)}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def assert_trees_rel_l2(got, want, tol):
    """Every leaf of the port's tree within ``tol`` relative L2 of the
    reference tree's leaf at the same path, and the same set of leaves."""
    want = np_tree(want)
    n = 0
    for path, leaf in tree_paths(got):
        w = want
        for key in path:
            w = w[key]
        g = leaf.detach().float().numpy()
        assert g.shape == np.shape(w), path
        assert rel_l2(g, w) <= tol, (path, rel_l2(g, w))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want))


def check_loss_and_grads(arch, efficient_ce):
    """Reduced ``arch``'s loss and every leaf's gradient, the port's
    ``grads_of`` against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same params and batch, within LOSS_RTOL and
    GRAD_REL_L2."""
    jcfg = jax_get_config(arch).reduced().replace(efficient_ce=efficient_ce)
    cfg = get_config(arch).reduced().replace(efficient_ce=efficient_ce)
    ref_params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = port(ref_params)
    batch = lm_batch(cfg)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jbatch)))(ref_params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = grads_of(cfg, params, tbatch)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    # loss_fn alone (no graph) gives the same loss
    with torch.no_grad():
        assert float(loss_fn(cfg, params, tbatch)) == float(loss)
    assert_trees_rel_l2(grads, want_grads, GRAD_REL_L2)
