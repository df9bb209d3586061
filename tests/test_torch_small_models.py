"""The char-LSTM and the speech CNN against the JAX package.

The same numpy inputs and params (carried over with repro_torch.convert)
go through repro.models.small and its port: the forward pass at reduced
widths and at Table I's, one client's local training, and the vectorized
executor against the eager loop, each within 1e-5.  The LSTM trains with
Table I's local SGD (lr 0.8) on int32 token matrices whose last batch is
partial (the executor pads it with masked samples).  The speech CNN
trains with local SGD too, not Table I's Adam: Adam divides a near-zero
gradient by its own root mean square, so where a ReLU input sits at 0 an
fp32 rounding difference between XLA's and PyTorch's convolutions
becomes a full step (ROADMAP Queue 3).  At init seed 0 one such flip puts
the eager loops of the two packages 1.5e-3 apart under Adam, while SGD
keeps every weight of every path within 1.5e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_char_lm as jax_make_char_lm
from repro.data import make_speech_commands as jax_make_speech
from repro.data.synthetic import ArrayDataset
from repro.fl import executor as jax_executor
from repro.fl.tasks import ClassificationTask as JaxTask
from repro.fl.tasks import TaskConfig as JaxTaskConfig
from repro.models import small as jax_small
from repro_torch.convert import params_from_numpy
from repro_torch.core.flatten import tree_leaves
from repro_torch.fl import executor
from repro_torch.fl.client import ClientPool
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.launch.train import build_dataset
from repro_torch.models import small

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (name, model args, input maker): reduced widths, then Table I's
LSTM_SMALL = (20, 4, 16)
SPEECH_SMALL = (16, 16, 7)


def _tokens(rng, vocab, shape):
    return rng.integers(0, vocab, size=shape).astype(np.int32)


CASES = {
    "lstm_reduced": ("make_char_lstm", LSTM_SMALL,
                     lambda rng: _tokens(rng, 20, (3, 9))),
    "lstm_table1": ("make_char_lstm", (82, 8, 256),
                    lambda rng: _tokens(rng, 82, (4, 80))),
    "speech_reduced": ("make_speech_cnn", SPEECH_SMALL,
                       lambda rng: rng.normal(size=(3, 16, 16, 1))
                       .astype(np.float32)),
    "speech_table1": ("make_speech_cnn", (32, 32, 35),
                      lambda rng: rng.normal(size=(3, 32, 32, 1))
                      .astype(np.float32)),
}


def _jax_init(jax_model, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    maker, args, make_x = CASES[case]
    jax_model = getattr(jax_small, maker)(*args)
    model = getattr(small, maker)(*args)
    init = _jax_init(jax_model)
    x = make_x(np.random.default_rng(1))
    want = np.asarray(jax_model.apply(init, jnp.asarray(x)))
    got = model.apply(params_from_numpy(init, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the port's own init draws the reference's tree: keys, shapes, dtypes
    own = model.init(0, torch.device("cpu"))
    assert (jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), init)
            == jax.tree_util.tree_map(
                lambda t: (tuple(t.shape), str(t.dtype)[6:]), own))


def test_registry_matches_jax():
    assert sorted(small.SMALL_MODELS) == sorted(jax_small.SMALL_MODELS)
    for name, make in small.SMALL_MODELS.items():
        assert make().name == jax_small.SMALL_MODELS[name]().name == name


@pytest.mark.parametrize("dataset,want", [("shakespeare", 818_402),
                                          ("speech", 67_267)])
def test_table1_param_counts(dataset, want):
    task, parts, _ = build_dataset(dataset, 10, device="cpu")
    assert sum(t.numel() for t in tree_leaves(task.init_params(0))) == want
    ds = next(iter(parts.values()))
    if dataset == "shakespeare":
        assert ds.x.dtype == np.int32 and ds.x.shape[1:] == (80,)
        assert (task.config.optimizer, task.config.learning_rate,
                task.config.batch_size, task.config.epochs) == \
            ("sgd", 0.8, 32, 1)
    else:
        assert ds.x.shape[1:] == (32, 32, 1)
        assert (task.config.optimizer, task.config.learning_rate,
                task.config.batch_size, task.config.epochs) == \
            ("adam", 1e-3, 5, 5)


# ------------------------------------------------------------ dropout
def _speech(args=SPEECH_SMALL, batch=2, seed=1):
    model = small.make_speech_cnn(*args)
    params = model.init(0, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, args[0], args[1], 1)).astype(np.float32))
    return model, params, x


def _recorded_blocks(monkeypatch):
    """Record (h, keep, out) of every dropout_plain call of a forward."""
    calls = []
    plain = small.dropout_plain

    def recording(h, keep, rate):
        out = plain(h, keep, rate)
        calls.append((h, keep, out))
        return out
    monkeypatch.setattr(small, "dropout_plain", recording)
    return calls


def test_speech_dropout_generator_raises():
    """dropout_rng takes a torch.Generator: a JAX key (a uint32 pair) is
    refused, and a generator gives logits."""
    model, params, x = _speech()
    with pytest.raises(TypeError, match="torch.Generator"):
        model.apply(params, x,
                    dropout_rng=np.asarray(jax.random.PRNGKey(0)))
    got = model.apply(params, x,
                      dropout_rng=torch.Generator().manual_seed(0))
    assert got.shape == (2, 7) and torch.isfinite(got).all()


@pytest.mark.parametrize("rate", [0.1, 0.25, 0.5])
def test_speech_dropout_formula_matches_reference(rate):
    """dropout_plain equals the reference's jnp.where(keep, h/(1-rate), 0)
    bit for bit on the same numpy mask."""
    rng = np.random.default_rng(2)
    h = rng.normal(size=(4, 8, 8, 32)).astype(np.float32)
    keep = rng.random(h.shape) < 1 - rate
    want = np.asarray(jnp.where(jnp.asarray(keep),
                                jnp.asarray(h) / (1 - rate), 0.0))
    got = small.dropout_plain(torch.from_numpy(h), torch.from_numpy(keep),
                              rate)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("args", [SPEECH_SMALL, (32, 32, 35)])
def test_speech_dropout_rate_zero_is_no_dropout(args):
    model, params, x = _speech(args)
    want = model.apply(params, x)
    got = model.apply(params, x, dropout_rng=torch.Generator().manual_seed(3),
                      rate=0.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_speech_dropout_share_and_kept_values(rate, monkeypatch):
    """At batch 64 each block drops within 4σ of ``rate``; kept entries
    are h / (1 - rate) exactly and dropped ones 0; the first block's
    pre-dropout activations are the no-dropout model's."""
    model, params, x = _speech(batch=64)
    calls = _recorded_blocks(monkeypatch)
    model.apply(params, x, dropout_rng=torch.Generator().manual_seed(4),
                rate=0.0)
    undropped = calls[0][0]
    calls.clear()
    model.apply(params, x, dropout_rng=torch.Generator().manual_seed(4),
                rate=rate)
    assert len(calls) == 2
    assert torch.equal(calls[0][0], undropped)
    for h, keep, out in calls:
        n = keep.numel()
        share = 1.0 - keep.float().mean().item()
        assert abs(share - rate) <= 4 * np.sqrt(rate * (1 - rate) / n)
        assert torch.equal(out[keep], h[keep] / (1 - rate))
        assert not out[~keep].any()


def test_speech_dropout_same_seed_same_logits():
    model, params, x = _speech(batch=8)

    def run(seed):
        return model.apply(params, x,
                           dropout_rng=torch.Generator().manual_seed(seed))
    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    assert not torch.equal(run(5), model.apply(params, x))


def test_speech_dropout_grads_flow_through_kept_entries_only():
    rate = 0.25
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(size=(3, 16, 4, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=h.shape).astype(np.float32))
    keep = torch.from_numpy(rng.random(h.shape) < 1 - rate)
    h.requires_grad_(True)
    (small.dropout_plain(h, keep, rate) * w).sum().backward()
    assert torch.equal(h.grad, torch.where(keep, w / (1 - rate), 0.0))
    # through the whole model: every param gets a finite gradient
    model, params, x = _speech(batch=4)
    params = {k: {n: t.requires_grad_(True) for n, t in p.items()}
              for k, p in params.items()}
    model.apply(params, x, dropout_rng=torch.Generator().manual_seed(8)
                ).square().sum().backward()
    for p in params.values():
        for t in p.values():
            assert t.grad is not None and torch.isfinite(t.grad).all()


@pytest.mark.parametrize("case", ["speech_reduced", "speech_table1"])
def test_speech_dropout_forward_matches_jax_on_its_masks(case, monkeypatch):
    """The whole forward against the reference's with a dropout key: the
    port given the masks the reference draws (one key, reused by both
    blocks: jax.random.bernoulli at each block's NHWC shape) gives its
    logits within 1e-5."""
    rate = 0.25
    _, args, make_x = CASES[case]
    jax_model = jax_small.make_speech_cnn(*args)
    model = small.make_speech_cnn(*args)
    init = _jax_init(jax_model)
    x = make_x(np.random.default_rng(1))
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_model.apply(init, jnp.asarray(x), dropout_rng=key,
                                      rate=rate))
    plain = small.dropout_plain

    def with_jax_mask(h, keep, rate):
        nhwc = (h.shape[0], h.shape[2], h.shape[3], h.shape[1])
        mask = np.array(jax.random.bernoulli(key, 1 - rate, nhwc))
        return plain(h, torch.from_numpy(mask).permute(0, 3, 1, 2), rate)
    monkeypatch.setattr(small, "dropout_plain", with_jax_mask)
    got = model.apply(params_from_numpy(init, "cpu"), torch.from_numpy(x),
                      dropout_rng=torch.Generator(), rate=rate)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not np.allclose(want, np.asarray(
        jax_model.apply(init, jnp.asarray(x))), **TOL)


# ------------------------------------------------------------ training
def _lstm_data():
    full = jax_make_char_lm(4 * 19, seq_len=12, vocab=20, seed=0)
    return full, dict(epochs=1, batch_size=8, learning_rate=0.8,
                      optimizer="sgd", per_sample_time_s=0.05)


def _speech_data():
    full = jax_make_speech(4 * 13, 16, 16, 7, seed=0)
    return full, dict(epochs=2, batch_size=5, learning_rate=0.05,
                      optimizer="sgd", per_sample_time_s=0.02)


SETUPS = {"lstm": ("make_char_lstm", LSTM_SMALL, _lstm_data),
          "speech": ("make_speech_cnn", SPEECH_SMALL, _speech_data)}


@pytest.fixture(scope="module", params=sorted(SETUPS))
def setup(request):
    maker, args, data = SETUPS[request.param]
    full, task_kw = data()
    x, y = np.asarray(full.x), np.asarray(full.y)
    n = len(x) // 4
    parts = {f"c{i}": ArrayDataset(x[i * n:(i + 1) * n],
                                   y[i * n:(i + 1) * n]) for i in range(4)}
    jax_task = JaxTask(getattr(jax_small, maker)(*args),
                       JaxTaskConfig(**task_kw))
    task = ClassificationTask(getattr(small, maker)(*args),
                              TaskConfig(**task_kw), device="cpu")
    init = _jax_init(jax_task.model)
    pool = ClientPool(task, parts, None, seed=0)
    cids = sorted(parts)
    return dict(parts=parts, jax_task=jax_task, task=task, init=init,
                params=params_from_numpy(init, "cpu"), pool=pool, cids=cids,
                seeds=[pool.client_seed(c, 0) for c in cids])


def _assert_trees_close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


def test_local_train_matches_jax(setup):
    cid, seed = setup["cids"][0], setup["seeds"][0]
    ds = setup["parts"][cid]
    assert len(ds) % setup["task"].config.batch_size      # a partial batch
    want, want_loss = setup["jax_task"].local_train(
        jax.tree_util.tree_map(jnp.asarray, setup["init"]), ds, seed=seed)
    got, loss = setup["task"].local_train(setup["params"], ds, seed=seed)
    assert abs(loss - want_loss) < 1e-5
    _assert_trees_close(got, want)


def test_run_group_matches_eager_and_jax(setup):
    task, params, cids = setup["task"], setup["params"], setup["cids"]
    datasets = [setup["parts"][c] for c in cids]
    got = executor.VectorizedExecutor(task).run_group(
        cids, datasets, params, 0.0, setup["seeds"])
    want_jax = jax_executor.VectorizedExecutor(setup["jax_task"]).run_group(
        cids, datasets, jax.tree_util.tree_map(jnp.asarray, setup["init"]),
        0.0, setup["seeds"])
    for cid, ds, seed in zip(cids, datasets, setup["seeds"]):
        want, want_loss = task.local_train(params, ds, seed=seed)
        assert abs(got[cid][1] - want_loss) < 1e-5
        _assert_trees_close(got[cid][0], want)
        assert abs(got[cid][1] - want_jax[cid][1]) < 1e-5
        _assert_trees_close(got[cid][0], want_jax[cid][0])
