"""The port's aggregation and merge pipeline against the JAX package's.

The same updates (numpy, from a seed) go through repro.core's
aggregation helpers and MergePipeline and through their ports, which run
the kernels' plain versions on the CPU.  Tolerances: 1e-6 for the
weighted sums (fp32, a few terms), 1e-5 for the optimizer steps (as the
kernel test of fed_agg_apply).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import merge as jax_merge
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation, merge

SHAPES = {"conv": {"b": (4,), "w": (3, 3, 1, 4)}, "out": {"b": (5,),
                                                         "w": (7, 5)}}


def _tree(rng, scale=1.0):
    return {layer: {name: (rng.normal(size=shape) * scale).astype(np.float32)
                    for name, shape in leaves.items()}
            for layer, leaves in SHAPES.items()}


def _updates(seed, n=4):
    """(numpy global params, [(cid, numpy params, n_samples, round)])."""
    rng = np.random.default_rng(seed)
    base = _tree(rng)
    ups = [(f"c{i}", _tree(rng, 0.1), int(rng.integers(5, 50)), i % 2)
           for i in range(n)]
    for _, p, _, _ in ups:
        for layer in p:
            for name in p[layer]:
                p[layer][name] += base[layer][name]
    return base, ups


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_updates(ups):
    return [jax_agg.ClientUpdate(cid, _as_jax(p), num_samples=n,
                                 round_number=r) for cid, p, n, r in ups]


def _port_updates(ups):
    return [aggregation.ClientUpdate(cid, params_from_numpy(p, "cpu"),
                                     num_samples=n, round_number=r)
            for cid, p, n, r in ups]


def _assert_close(got, want, tol):
    got = params_to_numpy(got)
    for layer in want:
        for name in want[layer]:
            np.testing.assert_allclose(got[layer][name],
                                       np.asarray(want[layer][name]),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{layer}/{name}")


def test_aggregation_helpers_match_jax():
    _, ups = _updates(0)
    j, t = _jax_updates(ups), _port_updates(ups)
    np.testing.assert_array_equal(aggregation.fedavg_coefficients(t),
                                  jax_agg.fedavg_coefficients(j))
    np.testing.assert_array_equal(
        aggregation.staleness_coefficients(t, 2),
        jax_agg.staleness_coefficients(j, 2))
    _assert_close(aggregation.fedavg_aggregate(t),
                  jax_agg.fedavg_aggregate(j), 1e-6)
    _assert_close(aggregation.staleness_aggregate(t, 2, tau=2),
                  jax_agg.staleness_aggregate(j, 2, tau=2), 1e-6)
    assert aggregation.staleness_aggregate(t, 9, tau=2) is None
    jax_run = jax_agg.RunningAggregator(1, tau=2)
    run = aggregation.RunningAggregator(1, tau=2)
    for ju, tu in zip(j, t):
        assert run.add(tu) == jax_run.add(ju)
    _assert_close(run.finalize(), jax_run.finalize(), 1e-6)


@pytest.mark.parametrize("mix", [1.0, 0.6])
def test_identity_merge_matches_jax(mix):
    """mix < 1 folds the global model in as an anchor row."""
    base, ups = _updates(1)
    coeffs = np.array([0.4, 0.3, 0.2, 0.1])
    want = jax_merge.MergePipeline().merge(_as_jax(base), _jax_updates(ups),
                                           coeffs, mix=mix)
    pipe = merge.MergePipeline()
    got = pipe.merge(params_from_numpy(base, "cpu"), _port_updates(ups),
                     coeffs, mix=mix)
    _assert_close(got, want, 1e-6)
    assert pipe.last_update_norm is None and pipe.steps == 0


@pytest.mark.parametrize("name", merge.SERVER_OPTS[1:] + ("sgd",))
def test_optimizer_merge_matches_jax(name):
    """Two server steps (the second reads the moments of the first),
    then a checkpoint round trip into a fresh pipeline."""
    cfg = dict(name=name, lr=0.05 if name != "sgd" else 0.5)
    jax_pipe = jax_merge.MergePipeline(jax_merge.ServerOptConfig(**cfg))
    pipe = merge.MergePipeline(merge.ServerOptConfig(**cfg))
    base, ups = _updates(2)
    coeffs = np.array([0.1, 0.2, 0.3, 0.4])
    jax_params, params = _as_jax(base), params_from_numpy(base, "cpu")
    for mix in (1.0, 0.7):
        jax_params = jax_pipe.merge(jax_params, _jax_updates(ups), coeffs,
                                    mix=mix)
        params = pipe.merge(params, _port_updates(ups), coeffs, mix=mix)
        _assert_close(params, jax_params, 1e-5)
        np.testing.assert_allclose(pipe.last_update_norm,
                                   jax_pipe.last_update_norm, rtol=1e-5)
    assert pipe.steps == jax_pipe.steps == 2

    jax_arrays, arrays = {}, {}
    state = pipe.state_dict(arrays)
    assert state == jax_pipe.state_dict(jax_arrays)
    assert sorted(arrays) == sorted(jax_arrays)
    for key in arrays:
        _assert_close(arrays[key], jax_arrays[key], 1e-5)
    restored = merge.MergePipeline(merge.ServerOptConfig(**cfg))
    restored.load_state_dict(state, {k: params_to_numpy(v)
                                     for k, v in arrays.items()})
    a = pipe.merge(params, _port_updates(ups), coeffs)
    b = restored.merge(params, _port_updates(ups), coeffs)
    for layer in a:
        for leaf in a[layer]:
            assert torch.equal(a[layer][leaf], b[layer][leaf])


def test_empty_merge_keeps_model():
    pipe = merge.MergePipeline(merge.ServerOptConfig(name="fedadam"))
    base = params_from_numpy(_updates(3)[0], "cpu")
    assert pipe.merge(base, [], ()) is base
    assert pipe.last_update_norm == 0.0
    with pytest.raises(ValueError):
        pipe.merge(None, _port_updates(_updates(3)[1]), np.ones(4) / 4)
