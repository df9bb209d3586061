"""The port's compression codecs and UpdateCompressor against the JAX
package's.

On the CPU the port's kernel wrappers run their plain versions; the JAX
side runs its jitted Pallas kernels in interpret mode (repro.kernels.ops),
the functions its main path calls.  The same numpy inputs go to both, and
codes, scales, decodes, masks, indices, reconstructions and residuals must
agree bit for bit.  The CUDA kernels themselves are held against the plain
versions in test_torch_cuda.py and chip_smoke.py.

The JAX package's ``test_repro_compress_env_kill_switch`` has no
counterpart: the port has no ``REPRO_COMPRESS`` switch, so a scheme other
than ``none`` always encodes (tested below as the ``none`` passthrough).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compress import SCHEMES as JAX_SCHEMES
from repro.core.compress import CompressionConfig as JaxCompressionConfig
from repro.core.compress import UpdateCompressor as JaxUpdateCompressor
from repro.kernels import ops
from repro.kernels.ref import int8_encode_ref
from repro_torch.convert import params_from_numpy
from repro_torch.core.compress import (SCHEMES, CompressionConfig,
                                       UpdateCompressor)
from repro_torch.core.flatten import flatten_params
from repro_torch.kernels import (int8_decode, int8_decode_plain,
                                 int8_encode, int8_encode_plain, topk_decode,
                                 topk_encode, topk_mask, topk_mask_plain)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _int8_both(x: np.ndarray, chunk: int):
    q, s = ops.int8_encode(jnp.asarray(x), chunk=chunk)
    q_t, s_t = int8_encode(torch.from_numpy(x), chunk)
    _equal(q_t, q)
    _equal(s_t, s)
    _equal(int8_decode(q_t, s_t, x.size), ops.int8_decode(q, s, x.size))
    return q_t, s_t


# ---------------------------------------------------------------- int8
@pytest.mark.parametrize("n,chunk", [(1000, 256), (64, 16), (257, 256),
                                     (5, 8), (600, 32), (777, 64)])
def test_int8_matches_jax(n, chunk):
    rng = np.random.default_rng(n + chunk)
    x = rng.normal(size=n).astype(np.float32) * rng.uniform(0.01, 10)
    _int8_both(x, chunk)


def test_int8_scale_is_the_jitted_reciprocal_product():
    """4,000 chunks of 256 values: the port's scale, absmax·fl32(1/127),
    equals the jitted reference's in every chunk.  The eager oracle
    divides by 127 and differs in the last bit of some scales, so this
    size catches a port that divides."""
    rng = np.random.default_rng(11)
    spread = np.repeat(rng.uniform(0.01, 10, 4000), 256)
    x = (rng.normal(size=4000 * 256) * spread).astype(np.float32)
    _, s_t = _int8_both(x, 256)
    _, s_div = int8_encode_ref(jnp.asarray(x), chunk=256)
    assert np.count_nonzero(s_t.numpy() != np.asarray(s_div)) > 0


def test_int8_roundtrip_exact_on_representable_grid():
    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, size=600).astype(np.float32) * 2.0 ** -3
    x[::256] = 127 * 2.0 ** -3             # pin every chunk's absmax
    q, s = _int8_both(x, 256)
    _equal(int8_decode(q, s, x.size), x)


def test_int8_zero_chunk_is_safe():
    x = np.zeros(512, np.float32)
    x[300] = 1.5                            # second chunk nonzero
    q, s = _int8_both(x, 256)
    assert not q[0].any() and float(s[0]) == 1.0
    _equal(int8_decode(q, s, 512), x)


# ---------------------------------------------------------------- top-k
def _topk_both(x: np.ndarray, k: int):
    idx, vals, decoded = ops.topk_encode(jnp.asarray(x), k)
    idx_t, vals_t, dec_t = topk_encode(torch.from_numpy(x), k)
    _equal(idx_t, idx)
    _equal(vals_t, vals)
    _equal(dec_t, decoded)
    _equal(topk_decode(idx_t, vals_t, x.size),
           ops.topk_decode(idx, vals, x.size))
    return idx_t, dec_t


@pytest.mark.parametrize("n,k", [(1000, 10), (4096, 41), (100, 100),
                                 (50, 80), (300, 15), (128, 13)])
def test_topk_matches_jax(n, k):
    x = np.random.default_rng(n * k).normal(size=n).astype(np.float32)
    _topk_both(x, k)


def test_topk_tie_stability_lowest_index_wins():
    x = np.tile([1.0, -1.0], 10).astype(np.float32)
    idx, decoded = _topk_both(x, 5)
    _equal(idx, np.arange(5, dtype=np.int32))
    want = np.zeros(20, np.float32)
    want[:5] = x[:5]
    _equal(decoded, want)


@pytest.mark.parametrize("seed", range(8))
def test_topk_tie_heavy_matches_jax(seed):
    """Integer-valued vectors: most magnitudes are shared, so the kept
    set and its order rest on the tie rule alone."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(5):
        n = int(rng.integers(2, 600))
        x = rng.integers(-3, 4, size=n).astype(np.float32)
        _topk_both(x, int(rng.integers(1, n)))


def test_topk_mask_matches_jax():
    rng = np.random.default_rng(12)
    x = rng.integers(-4, 5, size=3001).astype(np.float32)
    for tau, last_keep in ((3.0, 1500), (0.0, 10), (4.0, -1), (2.0, 3000)):
        want = ops.topk_mask(jnp.asarray(x), jnp.float32(tau),
                             jnp.int32(last_keep))
        got = topk_mask(torch.from_numpy(x), torch.tensor(tau),
                        torch.tensor(last_keep))
        _equal(got, want)


# ---------------------------------------------------- wrapper contracts
def test_wrappers_reject_bad_inputs():
    x = torch.zeros(10)
    q, s = int8_encode(torch.ones(10), 4)
    with pytest.raises(TypeError):
        int8_encode(x.double())
    with pytest.raises(ValueError):
        int8_encode(torch.zeros(2, 5))            # not (P,)
    with pytest.raises(ValueError):
        int8_encode(torch.zeros(0))               # empty
    with pytest.raises(ValueError):
        int8_encode(torch.zeros(20)[::2])         # not contiguous
    with pytest.raises(ValueError):
        int8_encode(x, chunk=0)
    with pytest.raises(ValueError):
        int8_encode(x.to("meta"))                 # neither cpu nor cuda
    with pytest.raises(TypeError):
        int8_decode(q.float(), s, 10)             # codes not int8
    with pytest.raises(TypeError):
        int8_decode(q, s[:2], 10)                 # scale per chunk
    with pytest.raises(ValueError):
        int8_decode(q, s, 13)                     # longer than the codes
    with pytest.raises(ValueError):
        int8_decode(q.to("meta"), s.to("meta"), 10)
    with pytest.raises(TypeError):
        topk_mask(x, torch.tensor(1.0, dtype=torch.float64), 3)
    with pytest.raises(TypeError):
        topk_mask(x, 1.0, 2.5)                    # last_keep not an int
    with pytest.raises(ValueError):
        topk_mask(x, torch.ones(2), 3)            # tau not one value
    with pytest.raises(ValueError):
        topk_mask(x.to("meta"), 1.0, 3)
    with pytest.raises(ValueError):
        topk_encode(x, 0)


def test_cpu_calls_do_not_count_launches():
    before = (int8_encode.launches, int8_decode.launches,
              topk_mask.launches)
    x = torch.from_numpy(np.random.default_rng(13).normal(size=300)
                         .astype(np.float32))
    q, s = int8_encode(x, 32)
    int8_decode(q, s, 300)
    topk_encode(x, 7)
    topk_mask(x, 0.5, 10)
    assert (int8_encode.launches, int8_decode.launches,
            topk_mask.launches) == before


def test_plain_versions_are_what_the_cpu_runs():
    x = torch.from_numpy(np.random.default_rng(14).normal(size=1000)
                         .astype(np.float32))
    q, s = int8_encode(x, 64)
    q_w, s_w = int8_encode_plain(x, 64)
    assert torch.equal(q, q_w) and torch.equal(s, s_w)
    assert torch.equal(int8_decode(q, s, 1000),
                       int8_decode_plain(q, s, 1000))
    assert torch.equal(topk_mask(x, 1.0, 500), topk_mask_plain(
        x, torch.tensor([1.0]), torch.tensor([500])))


# ------------------------------------------------------- error feedback
def _ef_telescopes(deltas, scheme, **cfg_kw):
    """EF invariant: Σ decoded_i + residual_N == Σ delta_i."""
    comp = UpdateCompressor(CompressionConfig(scheme=scheme,
                                              error_feedback=True, **cfg_kw))
    g = {"w": torch.zeros(deltas[0].size)}
    total_delta = np.zeros(deltas[0].size, np.float64)
    total_decoded = np.zeros(deltas[0].size, np.float64)
    for d in deltas:
        recon, payload, dense = comp.encode("c0", {"w": torch.from_numpy(d)},
                                            g)
        assert payload is not None and dense == d.size * 4
        total_delta += d.astype(np.float64)
        total_decoded += recon["w"].numpy().astype(np.float64)
    residual = comp._residuals["c0"].numpy().astype(np.float64)
    np.testing.assert_allclose(total_decoded + residual, total_delta,
                               rtol=1e-4, atol=1e-5)


def test_error_feedback_telescopes_deterministic():
    rng = np.random.default_rng(3)
    deltas = [rng.normal(size=300).astype(np.float32) for _ in range(5)]
    _ef_telescopes(deltas, "topk", topk_ratio=0.05)
    _ef_telescopes(deltas, "int8", chunk=64)


def test_error_feedback_accumulation_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.lists(st.integers(0, 2**32 - 1), min_size=2, max_size=6),
           st.sampled_from(["topk", "int8"]))
    def prop(seeds, scheme):
        deltas = [np.random.default_rng(s).normal(size=128)
                  .astype(np.float32) for s in seeds]
        kw = ({"topk_ratio": 0.1} if scheme == "topk" else {"chunk": 32})
        _ef_telescopes(deltas, scheme, **kw)

    prop()


def test_error_feedback_changes_second_encode():
    rng = np.random.default_rng(4)
    g = {"w": torch.zeros(200)}
    u = {"w": torch.from_numpy(rng.normal(size=200).astype(np.float32))}
    for ef, expect_same in ((True, False), (False, True)):
        comp = UpdateCompressor(CompressionConfig(
            scheme="topk", topk_ratio=0.05, error_feedback=ef))
        r1, _, _ = comp.encode("a", u, g)
        r2, _, _ = comp.encode("a", u, g)
        assert torch.equal(r1["w"], r2["w"]) == expect_same


def test_none_scheme_passes_the_update_through():
    comp = UpdateCompressor(CompressionConfig(scheme="none"))
    assert not comp.config.active
    u = {"w": torch.ones(10)}
    recon, payload, dense = comp.encode("a", u, {"w": torch.zeros(10)})
    assert recon is u and payload is None and dense is None
    flat = torch.ones(10)
    assert comp.encode_flat("a", flat, {"w": torch.zeros(10)})[0] is flat
    assert SCHEMES == JAX_SCHEMES
    with pytest.raises(ValueError, match="scheme"):
        CompressionConfig(scheme="fp8").normalized()


# -------------------------------------------- UpdateCompressor parity
LIKE = {"conv": {"b": (4,), "w": (3, 3, 1, 4)},
        "dense": {"b": (5,), "w": (36, 5)}}


def _tree(rng, scale=1.0):
    return {layer: {name: (rng.normal(size=shape) * scale).astype(np.float32)
                    for name, shape in leaves.items()}
            for layer, leaves in LIKE.items()}


def _jnp(tree):
    return {layer: {name: jnp.asarray(a) for name, a in leaves.items()}
            for layer, leaves in tree.items()}


def _flat_np(tree):
    return flatten_params(params_from_numpy(tree, "cpu"))[0].numpy()


@pytest.mark.parametrize("scheme,kw", [("int8", {"chunk": 32}),
                                       ("int8", {"chunk": 256}),
                                       ("topk", {"topk_ratio": 0.05}),
                                       ("topk", {"topk_ratio": 0.3})])
def test_update_compressor_matches_jax(scheme, kw):
    """3 rounds × 3 clients through both compressors: reconstructions,
    wire sizes and error-feedback residuals agree bit for bit, and the
    port's encode_flat row is the flatten of its encode."""
    rng = np.random.default_rng(21)
    jax_comp = JaxUpdateCompressor(JaxCompressionConfig(scheme=scheme, **kw))
    comp = UpdateCompressor(CompressionConfig(scheme=scheme, **kw))
    flat_comp = UpdateCompressor(CompressionConfig(scheme=scheme, **kw))
    for _ in range(3):
        g = _tree(rng)
        g_jax, g_t = _jnp(g), params_from_numpy(g, "cpu")
        for cid in ("c2", "c0", "c1"):
            u = {layer: {name: a + _tree(rng, 0.01)[layer][name]
                         for name, a in leaves.items()}
                 for layer, leaves in g.items()}
            want, w_payload, w_dense = jax_comp.encode(cid, _jnp(u), g_jax)
            got, payload, dense = comp.encode(
                cid, params_from_numpy(u, "cpu"), g_t)
            assert (payload, dense) == (w_payload, w_dense)
            for layer in want:
                for name in want[layer]:
                    _equal(got[layer][name], want[layer][name])
            row, *_ = flat_comp.encode_flat(cid, torch.from_numpy(
                _flat_np(u)), g_t)
            assert torch.equal(row, flatten_params(got)[0])
    assert sorted(comp._residuals) == sorted(jax_comp._residuals)
    for cid, res in comp._residuals.items():
        _equal(res, jax_comp._residuals[cid])
        assert torch.equal(flat_comp._residuals[cid], res)


def test_wire_sizes_match_the_codecs():
    P = 1000
    g = {"w": torch.zeros(P)}
    u = {"w": torch.ones(P)}
    int8 = UpdateCompressor(CompressionConfig(scheme="int8", chunk=256))
    assert int8.encode("a", u, g)[1:] == (P + 4 * 4, 4 * P)
    topk = UpdateCompressor(CompressionConfig(scheme="topk",
                                              topk_ratio=0.01))
    assert topk.encode("a", u, g)[1:] == (8 * 10, 4 * P)
    with pytest.raises(ValueError, match="cannot compress"):
        topk.encode("a", {"w": torch.ones(P + 1)}, g)


def test_compressor_state_roundtrips_through_array_store():
    rng = np.random.default_rng(7)
    comp = UpdateCompressor(CompressionConfig(scheme="topk",
                                              topk_ratio=0.1))
    g = params_from_numpy(_tree(rng, 0.0), "cpu")
    for cid in ("c1", "c0"):
        comp.encode(cid, params_from_numpy(_tree(rng), "cpu"), g)
    arrays = {}
    state = comp.state_dict(arrays)
    assert state == {"scheme": "topk", "clients": ["c0", "c1"]}
    assert set(arrays) == {"compress/residual/c0", "compress/residual/c1"}
    for tree in arrays.values():
        assert set(tree) == set(LIKE)
        for layer, leaves in LIKE.items():
            for name, shape in leaves.items():
                assert tree[layer][name].dtype == torch.float32
                assert tuple(tree[layer][name].shape) == shape
    fresh = UpdateCompressor(CompressionConfig(scheme="topk",
                                               topk_ratio=0.1))
    fresh.load_state_dict(state, arrays)
    for cid in ("c0", "c1"):
        assert torch.equal(fresh._residuals[cid], comp._residuals[cid])
    assert fresh.state_dict({}) == state
    mismatched = UpdateCompressor(CompressionConfig(scheme="int8"))
    with pytest.raises(ValueError, match="scheme"):
        mismatched.load_state_dict(state, arrays)
