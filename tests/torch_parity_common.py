"""Helpers shared by the port's parity tests of the model zoo: params and
caches carried from the JAX package into the port, tree comparisons, and
the serving path (forward, prefill, decode, greedy generate) held against
the JAX package's on a reduced config.

Params come from the JAX package's ``init_params`` and are carried into
the port with ``convert.params_from_numpy``; inputs are made with numpy
from a seed and handed to both.  The reduced configs compute in fp32.
A VLM config also gets image embeddings (normal × 0.1, as the reference
example makes them), and its cross blocks' ``xgate`` is set to XGATE in
the params' numpy tree before either package sees it: init makes it 0,
and tanh(0) = 0 would hide the whole cross path.
"""
import importlib.util
import re
import sys
from pathlib import Path

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
XGATE = 0.7                  # the cross blocks' gate: tanh(0.7) ≈ 0.6


def zoo_params(jcfg, seed=0):
    """The JAX package's init_params of ``jcfg`` as a numpy tree, with
    every cross block's ``xgate`` set to XGATE."""
    tree = np_tree(jax_init_params(jcfg, jax.random.PRNGKey(seed)))

    def gate(t):
        if isinstance(t, dict):
            return {k: (np.full_like(v, XGATE) if k == "xgate" else gate(v))
                    for k, v in t.items()}
        return t
    return gate(tree)


def image_embeds(cfg, B=2, seed=2):
    """(B, n_patches, d_model) fp32 vision features, normal × 0.1 from
    ``seed``, or None for a config without patches."""
    if not cfg.n_patches:
        return None
    return (np.random.default_rng(seed).normal(
        size=(B, cfg.n_patches, cfg.d_model)) * 0.1).astype(np.float32)


def with_images(batch, feats, to):
    """``batch`` plus ``image_embeds`` of ``feats`` (made by ``to``), when
    there are any."""
    return batch if feats is None else dict(batch, image_embeds=to(feats))


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


def jax_generate(cfg, params, prompt, new, feats=None):
    """examples/serve_decode.py's greedy loop: the prefill logits and
    cache, every decode step's (tokens, pos, logits, cache), and the
    generated ids (B, new).  A codebook model's prompt is (B, n_cb, S); it
    picks from the first codebook's logits and feeds every codebook.  A
    VLM's prefill takes the image embeddings ``feats``."""
    S = prompt.shape[-1]
    logits, cache = jax_prefill(
        cfg, params, with_images({"tokens": prompt}, feats, jnp.asarray),
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
    prompt ((2, n_cb, S) for codebooks; a VLM's with image embeddings and
    its gates at XGATE), against the JAX package within LOGIT_TOL; no
    kernel launches on the CPU."""
    jcfg = jax_get_config(arch).reduced().replace(
        use_pallas_attention=pallas)
    cfg = get_config(arch).reduced().replace(use_pallas_attention=pallas)
    if long_context:
        jcfg, cfg = jcfg.long_context(), cfg.long_context()
    tree = zoo_params(jcfg)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    params = port(tree)
    shape = (2, cfg.n_codebooks, S) if cfg.n_codebooks else (2, S)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, shape)
    jprompt = jnp.asarray(prompt, jnp.int32)
    tprompt = torch.from_numpy(prompt)
    feats = image_embeds(cfg)
    tfeats = None if feats is None else torch.from_numpy(feats)

    close(forward(cfg, params,
                  with_images({"tokens": tprompt}, feats, torch.from_numpy)),
          jax_forward(jcfg, ref_params,
                      with_images({"tokens": jprompt}, feats, jnp.asarray)),
          LOGIT_TOL)

    want_logits, want_cache, steps, want_ids = jax_generate(
        jcfg, ref_params, jprompt, new, feats)
    logits, cache = prefill(
        cfg, params, with_images({"tokens": tprompt}, feats,
                                 torch.from_numpy),
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
    out = generate(cfg, params, tprompt, new, image_embeds=tfeats)
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


# a leaf whose gradient is zero analytically (the router of a top-1 MoE:
# its combine weight p / p is 1 whatever p is) holds only rounding, so
# relative L2 means nothing there: both trees' leaf must instead be below
# ZERO_GRAD of the reference's largest leaf
ZERO_GRAD = 1e-6


def assert_trees_rel_l2(got, want, tol, zero_leaves=()):
    """Every leaf of the port's tree within ``tol`` relative L2 of the
    reference tree's leaf at the same path, and the same set of leaves.
    The paths in ``zero_leaves`` are instead shown zero in both trees:
    below ZERO_GRAD of the reference's largest leaf."""
    want = np_tree(want)
    floor = ZERO_GRAD * max(np.linalg.norm(np.asarray(w, np.float64))
                            for w in jax.tree_util.tree_leaves(want))
    zero_leaves = set(zero_leaves)
    n = 0
    for path, leaf in tree_paths(got):
        w = want
        for key in path:
            w = w[key]
        g = leaf.detach().float().numpy()
        assert g.shape == np.shape(w), path
        if path in zero_leaves:
            zero_leaves.remove(path)
            norms = (np.linalg.norm(np.asarray(w, np.float64)),
                     np.linalg.norm(g.astype(np.float64)))
            assert max(norms) < floor, (path, norms, floor)
        else:
            assert rel_l2(g, w) <= tol, (path, rel_l2(g, w))
        n += 1
    assert not zero_leaves, zero_leaves
    assert n == len(jax.tree_util.tree_leaves(want))


def check_loss_and_grads(arch, efficient_ce):
    """Reduced ``arch``'s loss and every leaf's gradient, the port's
    ``grads_of`` against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same params and batch (a VLM's with image
    embeddings and its gates at XGATE), within LOSS_RTOL and
    GRAD_REL_L2; a top-1 MoE's router gradients, zero analytically, are
    shown zero in both."""
    jcfg = jax_get_config(arch).reduced().replace(efficient_ce=efficient_ce)
    cfg = get_config(arch).reduced().replace(efficient_ce=efficient_ce)
    tree = zoo_params(jcfg)
    ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
    params = port(tree)
    batch = lm_batch(cfg)
    feats = image_embeds(cfg)
    jbatch = with_images({k: jnp.asarray(v, jnp.int32)
                          for k, v in batch.items()}, feats, jnp.asarray)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jbatch)))(ref_params)
    tbatch = with_images({k: torch.from_numpy(v) for k, v in batch.items()},
                         feats, torch.from_numpy)
    loss, grads = grads_of(cfg, params, tbatch)
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    # loss_fn alone (no graph) gives the same loss
    with torch.no_grad():
        assert float(loss_fn(cfg, params, tbatch)) == float(loss)
    routers = [path for path, _ in tree_paths(grads)
               if cfg.top_k == 1 and path[-1] == "router"]
    assert_trees_rel_l2(grads, want_grads, GRAD_REL_L2, zero_leaves=routers)


# ============================================================ example CLIs
# The JAX package's examples/*.py and their ports in repro_torch.examples
# run in this process at small settings through their own flags, the
# port's on the CPU.  The port's models draw their init params from the
# JAX package's init (``with_jax_init``), so the two runs train the same
# model: their outputs agree line by line, every virtual column (EUR,
# duration, cost, bias, time-to-accuracy, aggregation counts) as text and
# every accuracy within ACC_TOL (local Adam at ReLU margins, ROADMAP
# Queue 3).
REPO = Path(__file__).resolve().parents[1]
ACC_TOL = 0.01


def jax_example(name: str):
    """The JAX package's ``examples/<name>.py``, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_main(monkeypatch, capsys, module, argv):
    """(exit code, standard output) of ``module.main()`` under ``argv``."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    capsys.readouterr()
    try:
        rc = module.main() or 0
    except SystemExit as stop:
        rc = stop.code
    return rc, capsys.readouterr().out


def with_jax_init(jax_factory, port_factory):
    """``port_factory`` whose ModelDefs' ``init(seed, device)`` return
    ``jax_factory``'s same-argument ModelDef's ``init(PRNGKey(seed))``."""
    def make(*args, **kwargs):
        jax_model = jax_factory(*args, **kwargs)

        def init(seed=0, device=None):
            return params_from_numpy(
                np_tree(jax_model.init(jax.random.PRNGKey(seed))),
                device or "cpu")
        return port_factory(*args, **kwargs)._replace(init=init)
    return make


def split_accuracies(text: str, patterns):
    """``text`` with each first group of ``patterns`` (regexes, one group:
    an accuracy) replaced by ``<acc>``, and the accuracies in order."""
    found = []

    def take(match):
        found.append(float(match.group(1)))
        start, end = match.span(1)
        whole = match.group(0)
        base = match.start(0)
        return whole[:start - base] + "<acc>" + whole[end - base:]
    for pattern in patterns:
        text = re.sub(pattern, take, text, flags=re.MULTILINE)
    return text, found


def assert_outputs_agree(jax_out: str, port_out: str, patterns) -> float:
    """The two outputs equal line by line but for their accuracies, which
    agree within ACC_TOL; returns the largest accuracy gap."""
    jax_text, jax_acc = split_accuracies(jax_out, patterns)
    port_text, port_acc = split_accuracies(port_out, patterns)
    assert port_text.splitlines() == jax_text.splitlines()
    assert len(port_acc) == len(jax_acc) and jax_acc
    gap = max(abs(a - b) for a, b in zip(port_acc, jax_acc))
    assert gap <= ACC_TOL, (port_acc, jax_acc)
    return gap
