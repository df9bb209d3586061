"""The port's sequence-sharded flash decoding against the JAX package's
unsharded oracle.

The same numpy q and KV cache go to the port's ``sharded_decode_attention``
over 1-, 2- and 4-slot meshes of the CPU (the port's single-process
``launch.mesh.Mesh``, a device repeated as the card's runs repeat
``cuda:0``) and to the JAX package's ``reference_decode_attention``: fp32
within 2e-5, as tests/test_flash_decode.py holds the JAX package's own
sharded version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sharding.flash_decode import (
    reference_decode_attention as jax_reference_decode_attention)
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.flash_decode import (reference_decode_attention,
                                               sharded_decode_attention)

TOL = 2e-5


def _inputs(B, H, K, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, K, S, hd)).astype(np.float32)
    vc = rng.normal(size=(B, K, S, hd)).astype(np.float32)
    pos = rng.integers(0, S, size=(B,))
    pos[0] = 0                       # one valid slot: all in the first slab
    return q, kc, vc, pos


def _want(q, kc, vc, pos):
    return np.asarray(jax_reference_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(pos, jnp.int32)))


@pytest.mark.parametrize("axes", [
    (("model", 1),),
    (("model", 2),),
    (("model", 4),),
    (("data", 2), ("model", 2)),     # B split over data, S over model
    (("data", 1), ("model", 4)),
], ids=lambda axes: "x".join(f"{n}{s}" for n, s in axes))
def test_sharded_matches_reference(axes):
    B, H, K, S, hd = 4, 8, 4, 128, 16
    q, kc, vc, pos = _inputs(B, H, K, S, hd)
    pos[1] = S - 1                   # every slot valid
    n = int(np.prod([s for _, s in axes]))
    mesh = Mesh(("cpu",) * n, axes)
    got = sharded_decode_attention(*map(torch.from_numpy, (q, kc, vc, pos)),
                                   mesh)
    assert got.shape == (B, H, hd)
    np.testing.assert_allclose(got.numpy(), _want(q, kc, vc, pos), rtol=TOL,
                               atol=TOL)


def test_reference_decode_attention_matches():
    """The port's unsharded oracle against the JAX package's, at the VLM's
    decode shape cut in width (GQA groups of 4)."""
    q, kc, vc, pos = _inputs(2, 32, 8, 80, 32, seed=3)
    got = reference_decode_attention(*map(torch.from_numpy,
                                          (q, kc, vc, pos)))
    np.testing.assert_allclose(got.numpy(), _want(q, kc, vc, pos), rtol=TOL,
                               atol=TOL)


def test_cache_must_split_over_the_axis():
    q, kc, vc, pos = map(torch.from_numpy, _inputs(2, 4, 2, 30, 8))
    with pytest.raises(ValueError, match="does not split"):
        sharded_decode_attention(q, kc, vc, pos,
                                 Mesh(("cpu",) * 4, (("model", 4),)))
    with pytest.raises(ValueError, match="no axis"):
        sharded_decode_attention(q, kc, vc, pos,
                                 Mesh(("cpu",) * 2, (("data", 2),)))
