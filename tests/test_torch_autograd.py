"""Autograd through the port's kernels, remat, the new optimizers and the
codebook model, on the CPU.

- ``ssd_scan`` under autograd is ``_SSDScan``: the kernel (here its plain
  version) runs the forward and the plain version's vector-Jacobian
  product the backward.  Its grads equal direct autograd through
  ``ssd_scan_plain`` bit for bit here (the same fp32 graph on the same
  inputs), the head-broadcast views of B and C included, under
  ``torch.utils.checkpoint`` too.
- The other wrappers have no backward and raise under autograd rather
  than hand back an output without a gradient.
- Remat (``cfg.remat``) recomputes each superblock and leaves the grads
  bit for bit as they were.
- ``adamw`` and ``clip_by_global_norm`` against the JAX package's; the
  codebook model (musicgen-medium) serves as the JAX package does.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.configs import get_config
from repro_torch.core.flatten import tree_paths
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.launch.mesh import Mesh
from repro_torch.models import grads_of, init_params, transformer
from repro_torch.optim import clip_by_global_norm, make_optimizer
from torch_parity_common import (check_serving_path, lm_batch, np_tree,
                                 port)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU models gain nothing from intra-op threads, and with one
    the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ssd_leaves(shape, dtype, broadcast, seed=0):
    """x, a_dt and the bases of B and C at the JAX tests' scales, as
    leaves that require grad; B and C have one head when broadcast."""
    b, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    hb = 1 if broadcast else h
    x = rng.normal(size=(b, l, h, p)) * 0.5
    a = -np.abs(rng.normal(size=(b, l, h))) * 0.3
    B, C = (rng.normal(size=(b, l, hb, n)) * 0.5 for _ in range(2))
    return [torch.tensor(x, dtype=dtype, requires_grad=True),
            torch.tensor(a, dtype=torch.float32, requires_grad=True),
            torch.tensor(B, dtype=dtype, requires_grad=True),
            torch.tensor(C, dtype=dtype, requires_grad=True)]


def _scan_grads(fn, leaves, shape, chunk, use_state, remat=False):
    b, l, h, p, n = shape
    x, a, Bb, Cb = leaves

    def run(x, a, Bb, Cb):
        y, state = fn(x, a, Bb.expand(b, l, h, n), Cb.expand(b, l, h, n),
                      chunk=chunk, return_state=True)
        w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
        out = (y.float() * w).sum()
        return out + (state ** 2).sum() if use_state else out

    loss = (torch.utils.checkpoint.checkpoint(run, *leaves,
                                              use_reentrant=False)
            if remat else run(*leaves))
    return loss, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("use_state", [False, True])
@pytest.mark.parametrize("dtype,broadcast", [
    (torch.float32, True), (torch.float32, False), (torch.bfloat16, True)])
@pytest.mark.parametrize("shape,chunk", [
    ((2, 50, 3, 8, 4), 16), ((1, 64, 2, 16, 8), 64)])
def test_ssd_scan_grads_equal_plain_autograd(shape, chunk, dtype, broadcast,
                                             use_state, remat):
    leaves = _ssd_leaves(shape, dtype, broadcast)
    loss, got = _scan_grads(ssd_scan, leaves, shape, chunk, use_state,
                            remat)
    want_loss, want = _scan_grads(ssd_scan_plain, leaves, shape, chunk,
                                  use_state)
    assert float(loss.detach()) == float(want_loss.detach())
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        assert bool(g.float().abs().max() > 0)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_scan_grads_of_some_inputs_only():
    shape = (1, 40, 2, 8, 4)
    x, a, Bb, Cb = _ssd_leaves(shape, torch.float32, False)
    B, C = Bb.detach(), Cb.detach()
    got, want = (torch.autograd.grad(fn(x, a.detach(), B, C, chunk=16).sum(),
                                     [x])[0]
                 for fn in (ssd_scan, ssd_scan_plain))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with torch.no_grad():              # no graph: the kernel path alone
        y = ssd_scan(x, a, B, C, chunk=16)
    assert y.grad_fn is None and not y.requires_grad


def test_mamba_params_get_the_scans_grads():
    """The scan's params of a reduced mamba2-130m (A_log, dt_bias, the
    conv and in_proj's B, C and dt columns) reach their grads only through
    the scan: non-zero, and equal to the plain path's."""
    from repro_torch.models import ssm

    cfg = get_config("mamba2-130m").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()}
    _, grads = grads_of(cfg, params, batch)
    kernel = ssm.ssd_scan
    ssm.ssd_scan = ssd_scan_plain
    try:
        _, plain = grads_of(cfg, params, batch)
    finally:
        ssm.ssd_scan = kernel
    g, w = grads["blocks"]["pos0"]["mamba"], plain["blocks"]["pos0"]["mamba"]
    d_inner, N = cfg.d_inner, cfg.ssm_state
    scan_only = {"A_log": g["A_log"], "dt_bias": g["dt_bias"],
                 "conv_w B, C": g["conv_w"][:, d_inner:],
                 "in_proj B, C, dt": g["in_proj"][..., 2 * d_inner:]}
    assert g["in_proj"].shape[-1] == 2 * d_inner + 2 * N + cfg.ssm_heads
    for name, t in scan_only.items():
        assert bool((t.abs().amax(dim=-1) > 0).all()), name
    for key in g:
        torch.testing.assert_close(g[key], w[key], rtol=0, atol=0)


WRAPPERS = ("fed_agg", "fed_agg_apply", "fed_agg_sharded",
            "fed_agg_apply_sharded", "int8_encode", "int8_decode",
            "topk_mask", "flash_attention")


def _wrapper_calls():
    """Each ctypes wrapper, on CPU inputs the first of which is passed on
    to require grad."""
    fed_agg, compress, flash_attention = (
        importlib.import_module(f"repro_torch.kernels.{name}")
        for name in ("fed_agg", "compress", "flash_attention"))
    u, c = torch.randn(3, 300), torch.rand(3)
    p, m, v = torch.randn(300), torch.rand(300), torch.rand(300)
    hyper = (0.1, 1.0, 0.9, 0.99, 1e-3)
    mesh = Mesh(("cpu", "cpu"), (("data", 2), ("model", 1)))
    q, scale = compress.int8_encode(torch.randn(300))
    qkv = [torch.randn(1, 2, 16, 8) for _ in range(3)]
    return {
        "fed_agg": (fed_agg.fed_agg, [u, c]),
        "fed_agg_apply": (lambda *t: fed_agg.fed_agg_apply(*t, *hyper),
                          [u, c, p, m, v]),
        "fed_agg_sharded": (lambda *t: fed_agg.fed_agg_sharded(
            *t, mesh=mesh), [u, c]),
        "fed_agg_apply_sharded": (lambda *t: fed_agg.fed_agg_apply_sharded(
            *t, *hyper, mesh=mesh), [u, c, p, m, v]),
        "int8_encode": (compress.int8_encode, [torch.randn(300)]),
        "int8_decode": (lambda s, q: compress.int8_decode(q, s, 300),
                        [scale, q]),
        "topk_mask": (lambda x: compress.topk_mask(x, 0.5, 10),
                      [torch.randn(300)]),
        "flash_attention": (flash_attention.flash_attention, qkv),
    }


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_autograd(name):
    calls = _wrapper_calls()
    assert sorted(calls) == sorted(WRAPPERS)
    fn, args = calls[name]
    fn(*args)                                    # no input requires grad
    live = [args[0].clone().requires_grad_(True), *args[1:]]
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        fn(*live)
    with torch.no_grad():
        fn(*live)


def test_training_through_flash_attention_raises():
    """With use_pallas_attention the attention kernel has no backward, as
    in the JAX package, where jax.grad of the Pallas call raises."""
    cfg = get_config("gemma2-2b").reduced().replace(
        use_pallas_attention=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()}
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        grads_of(cfg, params, batch)
    with torch.no_grad():
        transformer.forward(cfg, params, batch)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "gemma2-2b"])
def test_remat_leaves_grads_as_they_were(arch, monkeypatch):
    cfg = get_config(arch).reduced().replace(n_layers=2 * get_config(
        arch).reduced().period)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in lm_batch(cfg).items()}
    loss, want = grads_of(cfg, params, batch)
    calls = []
    real = transformer.checkpoint

    def counted(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    remat_loss, got = grads_of(cfg.replace(remat=True), params, batch)
    assert len(calls) == cfg.n_super == 2
    assert all(kw == {"use_reentrant": False} for kw in calls)
    assert float(remat_loss) == float(loss)
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=str(path))
    with torch.no_grad():                  # no graph: no checkpoint
        transformer.forward(cfg.replace(remat=True), params, batch)
    assert len(calls) == 2


def test_adamw_and_clip_match_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 5)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda t: (rng.normal(size=t.shape) * 3).astype(np.float32), params)
        for _ in range(3)]
    jopt, opt = (jax_make_optimizer("adamw", 1e-2),
                 make_optimizer("adamw", 1e-2))
    jstate, state = jopt.init(params), opt.init(port(params))
    for g in grads:
        jupd, jstate = jopt.update(g, jstate, params)
        upd, state = opt.update(port(g), state, port(params))
        for path, t in tree_paths(upd):
            w = np.asarray(jupd[path[0]] if len(path) == 1
                           else jupd[path[0]][path[1]])
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=1e-9)
    for max_norm in (0.5, 1e6):
        want = np_tree(jax_clip(grads[0], max_norm))
        got = clip_by_global_norm(port(grads[0]), max_norm)
        for path, t in tree_paths(got):
            w = want[path[0]] if len(path) == 1 else want[path[0]][path[1]]
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-6, atol=0)


@pytest.mark.parametrize("pallas", [False, True])
def test_musicgen_serving_matches_reference(pallas):
    check_serving_path("musicgen-medium", pallas, S=24)

