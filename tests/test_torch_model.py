"""The port's CNN and one client's local training against the JAX package,
from the same params, data and seed."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import make_image_classification
from repro.fl.tasks import ClassificationTask as JaxTask
from repro.fl.tasks import TaskConfig as JaxTaskConfig
from repro.models.small import make_cnn as jax_make_cnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.models.small import make_cnn


def _params(model):
    return jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(0)))


def _assert_trees_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(got[layer][name],
                                       np.asarray(want[layer][name]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{layer}/{name}")


def test_cnn_forward_matches_jax():
    jax_model = jax_make_cnn(14, 1, 5, 64)
    params = _params(jax_model)
    x = np.random.default_rng(1).normal(size=(16, 14, 14, 1)).astype(
        np.float32)
    want = np.asarray(jax_model.apply(params, jnp.asarray(x)))
    got = make_cnn(14, 1, 5, 64).apply(params_from_numpy(params, "cpu"),
                                       torch.from_numpy(x))
    assert got.shape == want.shape == (16, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cnn_init_shapes_match_jax():
    want = _params(jax_make_cnn(28, 1, 62, 2048))
    got = make_cnn(28, 1, 62, 2048).init(seed=0)
    for layer in want:
        for name in want[layer]:
            assert tuple(got[layer][name].shape) == want[layer][name].shape
            assert got[layer][name].dtype == torch.float32
    assert sum(t.numel() for layer in got.values()
               for t in layer.values()) == 6_603_710


def test_local_train_matches_jax():
    """Adam, 2 epochs, FedProx term on: final params within 1e-5."""
    jax_model = jax_make_cnn(14, 1, 5, 64)
    params = _params(jax_model)
    ds = make_image_classification(120, 14, 5, seed=3)
    cfg = dict(epochs=2, batch_size=16)
    want, want_loss = JaxTask(jax_model, JaxTaskConfig(**cfg)).local_train(
        params, ds, mu=0.001, seed=7)
    task = ClassificationTask(make_cnn(14, 1, 5, 64), TaskConfig(**cfg),
                              device="cpu")
    got, got_loss = task.local_train(params_from_numpy(params, "cpu"), ds,
                                     mu=0.001, seed=7)
    _assert_trees_close(params_to_numpy(got), want, 1e-5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)


def test_optimizers_match_jax():
    """Three steps of each optimizer, the FedProx term and the global
    norm, on the same params and gradients."""
    from repro.optim import optimizers as jax_opt
    from repro_torch.optim import optimizers as opt

    rng = np.random.default_rng(5)
    params = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(3)]
    for name, kw in (("adam", {}), ("sgd", {}), ("sgd", {"momentum": 0.9})):
        jax_o = jax_opt.make_optimizer(name, 0.01, **kw)
        o = opt.make_optimizer(name, 0.01, **kw)
        jp, js = params, jax_o.init(params)
        tp = params_from_numpy(params, "cpu")
        ts = o.init(tp)
        for g in grads:
            g_j = jax_opt.proximal_grad(g, jp, params, 0.01)
            g_t = opt.proximal_grad(params_from_numpy(g, "cpu"), tp,
                                    params_from_numpy(params, "cpu"), 0.01)
            u, js = jax_o.update(g_j, js, jp)
            jp = jax_opt.apply_updates(jp, u)
            u, ts = o.update(g_t, ts, tp)
            tp = opt.apply_updates(tp, u)
        got = params_to_numpy(tp)
        np.testing.assert_allclose(got["a"]["w"], jp["a"]["w"], rtol=1e-6,
                                   atol=1e-7, err_msg=f"{name} {kw}")
        np.testing.assert_allclose(got["b"], jp["b"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(opt.global_norm(tp)),
                                   float(jax_opt.global_norm(jp)), rtol=1e-6)
