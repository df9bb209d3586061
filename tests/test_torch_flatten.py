"""flatten_params lays a params tree out exactly as ravel_pytree does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.models.small import make_cnn as jax_make_cnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.flatten import flatten_params


def _cnn_params():
    params = jax_make_cnn(14, 1, 5, 64).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def test_flatten_matches_ravel_pytree():
    params = _cnn_params()
    want, _ = ravel_pytree(params)
    flat, _ = flatten_params(params_from_numpy(params, "cpu"))
    assert flat.dtype == torch.float32
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))


def test_unflatten_round_trips():
    params = params_from_numpy(_cnn_params(), "cpu")
    flat, unflatten = flatten_params(params)
    back = params_to_numpy(unflatten(flat.clone()))
    want = params_to_numpy(params)
    assert sorted(back) == sorted(want)
    for layer in want:
        for name in want[layer]:
            assert back[layer][name].shape == want[layer][name].shape
            np.testing.assert_array_equal(back[layer][name],
                                          want[layer][name])
    with pytest.raises(ValueError):
        unflatten(flat[:-1])


def test_mixed_dtypes_promote_like_jax():
    tree = {"b": np.arange(3, dtype=np.float16),
            "a": {"w": np.ones((2, 2), np.float32)}}
    want, unravel = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, tree))
    flat, unflatten = flatten_params(params_from_numpy(tree, "cpu"))
    assert str(flat.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    assert unflatten(flat)["b"].dtype == torch.float16
