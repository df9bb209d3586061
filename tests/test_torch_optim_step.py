"""``Optimizer.step`` and the ``adam`` kernel's plain version on the CPU.

``step`` must give the bits of ``proximal_grad`` → ``update`` →
``apply_updates`` for every optimizer, FedProx term and param dtype, on a
(K, ...) stacked tree with one anchor shared by its K rows, as the
executor runs it.  ``adam_plain`` must give the bits of PyTorch's unfused
passes written out here, which are what the card's kernel is held to
(tests/test_torch_cuda.py).
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.flatten import tree_leaves, tree_map
from repro_torch.kernels import adam, adam_plain
from repro_torch.kernels.adam import check_kernel_dtypes
from repro_torch.optim import (Optimizer, apply_updates, make_optimizer,
                               proximal_grad)

K = 3
SHAPES = {"conv": {"b": (5,), "w": (2, 3, 3)}, "fc": {"b": (7,),
                                                      "w": (6, 4)}}
STEPS = 3


def _tree(rng, shape_of, dtype, scale=1.0):
    return tree_map(lambda s: torch.from_numpy(
        (rng.normal(size=shape_of(s)) * scale).astype(np.float32)).to(dtype),
        SHAPES)


def _stacked(seed, dtype):
    """(params, anchor, grads of STEPS steps): K stacked rows, the anchor
    one row's shape."""
    rng = np.random.default_rng(seed)
    anchor = _tree(rng, lambda s: s, dtype)
    params = tree_map(lambda a: a + torch.from_numpy(rng.normal(
        size=(K, *a.shape)).astype(np.float32) * 0.1).to(dtype), anchor)
    grads = [_tree(rng, lambda s: (K, *s), dtype, 0.5) for _ in range(STEPS)]
    return params, anchor, grads


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _composed(opt, grads, state, params, anchor, mu):
    grads = proximal_grad(grads, params, anchor, mu)
    updates, state = opt.update(grads, state, params)
    return apply_updates(params, updates), state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_step_equals_composition(name, mu, dtype):
    opt = make_optimizer(name, 1e-2)
    params, anchor, grads = _stacked(7, dtype)
    before = tree_map(torch.clone, params)
    p_step, s_step = params, opt.init(params)
    p_comp, s_comp = params, opt.init(params)
    for g in grads:
        p_step, s_step = opt.step(g, s_step, p_step, anchor, mu)
        p_comp, s_comp = _composed(opt, g, s_comp, p_comp, anchor, mu)
        assert s_step["count"] == s_comp["count"]
        assert _equal(p_step, p_comp)
        for key in ("m", "v", "velocity"):
            if key in s_comp:
                assert _equal(s_step[key], s_comp[key])
    assert all(t.dtype == dtype for t in tree_leaves(p_step))
    assert _equal(params, before)            # the inputs are not written
    assert not _equal(p_step, params)


def _unfused(params, grads, m, v, anchor, mu, lr, b1, b2, eps, wd, count):
    """PyTorch's passes for one Adam step, leaf by leaf, as the port ran
    them before the kernel."""
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    out = []
    for p, g, m_, v_, a in zip(params, grads, m, v, anchor):
        if mu != 0.0:
            g = g + mu * (p - a).to(g.dtype)
        m_ = b1 * m_ + (1 - b1) * g.float()
        v_ = b2 * v_ + (1 - b2) * torch.square(g.float())
        upd = -lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
        if wd:
            upd = upd - lr * wd * p.float()
        out.append((p + upd.to(p.dtype), m_, v_))
    return [list(x) for x in zip(*out)]


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_adam_plain_equals_unfused_passes(dtype, mu, wd):
    params, anchor, grads = _stacked(11, dtype)
    p, a = tree_leaves(params), tree_leaves(anchor)
    m = [torch.zeros(t.shape) for t in p]
    v = [torch.zeros(t.shape) for t in p]
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    launches = adam.launches
    for count, g in enumerate(grads, start=1):
        g = tree_leaves(g)
        bc = {f"bc{i}": float(np.float32(1) - np.float32(b) ** np.float32(
            count)) for i, b in ((1, hyper["b1"]), (2, hyper["b2"]))}
        want = _unfused(p, g, m, v, a, mu, *hyper.values(), wd, count)
        got = adam_plain(p, g, m, v, anchor=a, mu=mu, weight_decay=wd,
                         **hyper, **bc)
        routed = adam(p, g, m, v, anchor=a, mu=mu, weight_decay=wd,
                      **hyper, **bc)
        for w, x, y in zip(want, got, routed):
            assert all(torch.equal(s, t) for s, t in zip(w, x))
            assert all(torch.equal(s, t) for s, t in zip(w, y))
        upd, _, _ = adam_plain(p, g, m, v, anchor=a, mu=mu, weight_decay=wd,
                               apply=False, **hyper, **bc)
        assert all(u.dtype == torch.float32 for u in upd)
        p, m, v = want
    assert adam.launches == launches          # the CPU runs no kernel


@pytest.mark.parametrize("rows_of", [1, 5, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_adam_plain_slices_equal_whole_leaves(monkeypatch, dtype, rows_of):
    """A leaf over PLAIN_SLICE elements runs in slices of its first dim
    (with a stacked anchor and with one of the leaf's own shape): the same
    bits as the passes over the whole leaf."""
    module = importlib.import_module("repro_torch.kernels.adam")
    rng = np.random.default_rng(rows_of)
    shapes = [((K, 6, 4), (6, 4)), ((10, 3), (10, 3)), ((13,), (13,)),
              ((), ())]

    def leaf(shape, scale=1.0):
        return torch.from_numpy(np.asarray(
            rng.normal(size=shape) * scale, dtype=np.float32)).to(dtype)

    p = [leaf(s) for s, _ in shapes]
    g = [leaf(s, 0.5) for s, _ in shapes]
    a = [leaf(s) for _, s in shapes]
    m = [leaf(s, 0.01).float() for s, _ in shapes]
    v = [leaf(s, 0.01).float().square() for s, _ in shapes]
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    want = _unfused(p, g, m, v, a, 0.01, *hyper.values(), 0.01, 2)
    monkeypatch.setattr(module, "PLAIN_SLICE", rows_of)
    got = adam_plain(p, g, m, v, anchor=a, mu=0.01, weight_decay=0.01,
                     bc1=float(np.float32(1) - np.float32(0.9) ** 2),
                     bc2=float(np.float32(1) - np.float32(0.999) ** 2),
                     **hyper)
    for w, x in zip(want, got):
        assert all(s.dtype == t.dtype and torch.equal(s, t)
                   for s, t in zip(w, x))


def test_kernel_refuses_cuda_only_dtypes():
    f32, bf16 = (torch.zeros(4, 8, dtype=d)
                 for d in (torch.float32, torch.bfloat16))
    check_kernel_dtypes([f32, bf16], [f32, bf16], [f32, f32], [f32, f32],
                        [f32[0], bf16[0]])
    half, dbl = f32.half(), f32.double()
    for args in (([half], [half], [f32], [f32], None),     # fp16 params
                 ([f32], [dbl], [f32], [f32], None),       # fp64 grads
                 ([f32], [bf16], [f32], [f32], None),      # grads' dtype
                 ([f32], [f32], [bf16], [f32], None),      # bf16 moments
                 ([bf16], [bf16], [f32], [f32], [f32[0]])):  # anchor dtype
        with pytest.raises(TypeError, match="adam's kernel takes"):
            check_kernel_dtypes(*args)
    # the plain version takes them: fp64 leaves on the CPU
    out, _, _ = adam([dbl], [dbl], [f32], [f32], lr=1e-3, b1=0.9, b2=0.999,
                     eps=1e-8, weight_decay=0.0, bc1=0.1, bc2=0.001)
    assert out[0].dtype == torch.float64


def test_rebuilt_optimizer_runs_its_own_update():
    """``Optimizer(opt.init, wrapped)`` has no fused step: ``step`` runs the
    wrapped update, so a caller that wraps the update sees every step."""
    opt = make_optimizer("adam", 1e-3)
    seen = []

    def wrapped(grads, state, params):
        seen.append(state["count"])
        return opt.update(grads, state, params)

    tapped = type(opt)(opt.init, wrapped)
    assert opt.fused_step is not None and tapped.fused_step is None
    params, anchor, grads = _stacked(3, torch.float32)
    p_t, s_t = params, tapped.init(params)
    p_o, s_o = params, opt.init(params)
    for g in grads:
        p_t, s_t = tapped.step(g, s_t, p_t, anchor, 0.0)
        p_o, s_o = opt.step(g, s_o, p_o, anchor, 0.0)
    assert seen == list(range(STEPS))
    assert _equal(p_t, p_o) and _equal(s_t["m"], s_o["m"])


def test_step_needs_an_anchor_for_fedprox():
    opt = make_optimizer("adam", 1e-3)
    params, _, grads = _stacked(5, torch.float32)
    with pytest.raises(ValueError, match="anchor"):
        opt.step(grads[0], opt.init(params), params, None, 0.01)
    assert isinstance(opt, Optimizer)
