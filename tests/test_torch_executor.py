"""The port's vectorized executor against the eager loop and the JAX
package's executor, on a tiny CNN and in whole experiments.

The same numpy data and params (carried over with repro_torch.convert)
go through repro.fl.executor and its port.  The executor trains the
cohort with ``torch.func.vmap`` over per-client params, which batches the
convolutions differently from the eager loop; per client, params and
mean loss agree with the eager loop and with the JAX executor within
1e-5.  The batches hold 8 of each client's 20 samples, so every epoch
ends with a partial batch of 4 padded with masked samples.

The experiment tests run experiment seed 3, as tests/test_torch_experiment.py
does: local Adam turns an fp32 sign flip at a ReLU margin into a full
step, and seed 3 has no flip in these runs either (ROADMAP Queue 3).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import label_sorted_shards
from repro.data import make_image_classification as jax_make_data
from repro.data.synthetic import ArrayDataset
from repro.faas.trace import load_jsonl
from repro.fl import controller as jax_controller
from repro.fl import executor as jax_executor
from repro.fl import experiment as jax_experiment
from repro.fl.client import ClientPool as JaxPool
from repro.fl.tasks import ClassificationTask as JaxTask
from repro.fl.tasks import TaskConfig as JaxTaskConfig
from repro.models.small import make_cnn as jax_make_cnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compress as port_compress
from repro_torch.core import reset_transfer_stats, transfer_stats
from repro_torch.core.flatten import flatten_params, tree_leaves
from repro_torch.fl import executor, experiment
from repro_torch.fl.client import ClientPool
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.kernels import KERNELS
from repro_torch.kernels import compress as port_codecs
from repro_torch.models.small import make_cnn

TOL = dict(rtol=1e-5, atol=1e-5)
TASK = dict(epochs=2, batch_size=8, per_sample_time_s=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,batch,epochs,seed", [
    (20, 10, 1, 0), (20, 8, 2, 1), (204, 10, 5, 7), (7, 16, 3, 2),
    (1, 4, 2, 5)])
def test_batch_indices_and_bucket_match_jax(n, batch, epochs, seed):
    idx, mask = executor._batch_indices(n, batch, epochs,
                                        np.random.default_rng(seed))
    want_idx, want_mask = jax_executor._batch_indices(
        n, batch, epochs, np.random.default_rng(seed))
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(mask, want_mask)
    assert mask.sum() == n * epochs
    # the loader's order: epoch e is the e-th permutation of a fresh rng
    rng = np.random.default_rng(seed)
    flat = idx[mask > 0]
    for e in range(epochs):
        np.testing.assert_array_equal(flat[e * n:(e + 1) * n],
                                      rng.permutation(n))
    for k in range(1, 3 * n + 2):
        for mult in (1, 2, 3, 8):
            assert executor._bucket(k, mult) == jax_executor._bucket(k, mult)


@pytest.fixture(scope="module")
def setup():
    full = jax_make_data(160, image_size=14, n_classes=4, seed=0)
    x, y = np.asarray(full.x), np.asarray(full.y)
    parts = {f"c{i}": ArrayDataset(x[i * 20:(i + 1) * 20],
                                   y[i * 20:(i + 1) * 20])
             for i in range(8)}
    jax_task = JaxTask(jax_make_cnn(14, 1, 4, 8, "tiny"),
                       JaxTaskConfig(**TASK))
    init = jax.tree_util.tree_map(np.asarray, jax_task.init_params(0))
    task = ClassificationTask(make_cnn(14, 1, 4, 8, "tiny"),
                              TaskConfig(**TASK), device="cpu")
    pool = ClientPool(task, parts, None, proximal_mu=0.0, seed=0)
    return dict(parts=parts, jax_task=jax_task, init=init, task=task,
                pool=pool, params=params_from_numpy(init, "cpu"))


def _group(pool, cids, round_number=0):
    return ([pool.clients[c].dataset for c in cids],
            [pool.client_seed(c, round_number) for c in cids])


def _assert_trees_close(got, want):
    """Leaves in sorted-key order (either package's tree) within TOL."""
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("mu", [0.0, 0.01])
def test_run_group_matches_eager_local_train(setup, mu):
    task, pool, params = setup["task"], setup["pool"], setup["params"]
    cids = [f"c{i}" for i in range(4)]
    datasets, seeds = _group(pool, cids)
    got = executor.VectorizedExecutor(task).run_group(cids, datasets, params,
                                                      mu, seeds)
    for cid, ds, seed in zip(cids, datasets, seeds):
        want, want_loss = task.local_train(params, ds, mu=mu, seed=seed)
        assert abs(got[cid][1] - want_loss) < 1e-5
        _assert_trees_close(got[cid][0], want)


def test_run_group_matches_jax_executor(setup):
    pool = setup["pool"]
    cids = [f"c{i}" for i in range(4)]
    datasets, seeds = _group(pool, cids)
    jax_pool = JaxPool(setup["jax_task"], setup["parts"], None, seed=0)
    assert seeds == [jax_pool.client_seed(c, 0) for c in cids]
    want = jax_executor.VectorizedExecutor(setup["jax_task"]).run_group(
        cids, datasets, jax.tree_util.tree_map(jnp.asarray, setup["init"]),
        0.0, seeds)
    got = executor.VectorizedExecutor(setup["task"]).run_group(
        cids, datasets, setup["params"], 0.0, seeds)
    for cid in cids:
        assert abs(got[cid][1] - want[cid][1]) < 1e-5
        _assert_trees_close(got[cid][0], want[cid][0])


def test_run_group_pads_a_cohort_of_three(setup):
    """Three clients train in a bucket of four (the last repeated); each
    equals its eager run, and the dispatch count stays flat.

    Local SGD here: the point is the padding.  Under local Adam this
    round's client c6 ends 1.6e-5 from its eager run on one conv2 weight
    while SGD keeps every weight within 3e-7: Adam divides a near-zero
    gradient by its own root mean square, so fp32 rounding differences of
    the batched convolution become step-sized (ROADMAP Queue 3)."""
    task = ClassificationTask(make_cnn(14, 1, 4, 8, "tiny"),
                              TaskConfig(optimizer="sgd", learning_rate=0.05,
                                         **TASK), device="cpu")
    pool = ClientPool(task, setup["parts"], None, proximal_mu=0.0, seed=0)
    params = setup["params"]
    ex = executor.VectorizedExecutor(task)
    cids = ["c5", "c6", "c7"]
    datasets, seeds = _group(pool, cids, round_number=2)
    batch = ex.run_group_batch(cids, datasets, params, 0.0, seeds)
    assert batch.mat.shape == (4, batch.num_params)
    assert ex.compile_count == 1
    got = ex.run_group(cids, datasets, params, 0.0, seeds)
    assert ex.compile_count == 1                 # same bucket, same shapes
    for cid, ds, seed in zip(cids, datasets, seeds):
        want, want_loss = task.local_train(params, ds, seed=seed)
        assert abs(got[cid][1] - want_loss) < 1e-5
        _assert_trees_close(got[cid][0], want)
    # the padded row trains the last client again
    assert torch.equal(batch.mat[3], batch.mat[2])
    ex.run_group(cids[:2], datasets[:2], params, 0.0, seeds[:2])
    assert ex.compile_count == 2                 # bucket 2 is new


def test_run_group_batch_rows_are_flattened_trees(setup):
    task, pool, params = setup["task"], setup["pool"], setup["params"]
    cids = [f"c{i}" for i in range(4)]
    datasets, seeds = _group(pool, cids)
    ex = executor.VectorizedExecutor(task)
    trees = ex.run_group(cids, datasets, params, 0.0, seeds)
    reset_transfer_stats()
    batch = ex.run_group_batch(cids, datasets, params, 0.0, seeds)
    assert batch.num_clients == 4
    assert batch.num_params == flatten_params(params)[0].numel()
    assert transfer_stats()["materialize_rows"] == 0
    for i, cid in enumerate(cids):
        flat = flatten_params(trees[cid][0])[0]
        assert torch.equal(batch.row(i), flat)
        for a, b in zip(tree_leaves(batch.tree(i)),
                        tree_leaves(trees[cid][0])):
            assert torch.equal(a, b)
        assert batch.loss(i) == trees[cid][1]
    stats = transfer_stats()
    assert stats["materialize_rows"] == 4 and stats["loss_syncs"] == 1
    assert stats["materialize_bytes"] == 4 * 4 * batch.num_params
    assert torch.equal(batch.gather([2, 0]),
                       torch.stack([batch.row(2), batch.row(0)]))
    batch.set_row(1, torch.zeros(batch.num_params))
    assert torch.equal(batch.gather([1, 3])[0],
                       torch.zeros(batch.num_params))
    with pytest.raises(IndexError):
        batch.row(4)                             # the bucket's pad row


# ------------------------------------------------------------ experiments
SEED = 3
N_CLIENTS = 6


def _data():
    full = jax_make_data(600, 14, 5, seed=0)
    train = ArrayDataset(full.x[:500], full.y[:500])
    test = ArrayDataset(full.x[500:], full.y[500:])
    return (label_sorted_shards(train, N_CLIENTS, 2),
            label_sorted_shards(test, N_CLIENTS, 2))


def _config(module, strategy, trace_path, **kw):
    return module.ExperimentConfig(
        strategy=strategy, n_rounds=3, clients_per_round=4, eval_every=3,
        seed=SEED, trace_path=str(trace_path),
        scenario=module.ScenarioConfig(straggler_fraction=0.3,
                                       round_timeout_s=30.0), **kw)


@functools.cache
def _jax_task(task_kw: tuple):
    """One JAX task per task config, shared by the tests: its executor
    (cached on the task) compiles each bucket once for all of them."""
    cfg = dict(epochs=2, batch_size=32, per_sample_time_s=0.05,
               **dict(task_kw))
    return JaxTask(jax_make_cnn(14, 1, 5, 64), JaxTaskConfig(**cfg)), cfg


def _run_three(tmp_path, monkeypatch, strategy, task_kw=None, **kw):
    """The JAX package's vectorized run, the port's vectorized run and the
    port's eager run of one configuration; returns their final params."""
    parts, test_parts = _data()
    jax_task, task_cfg = _jax_task(tuple(sorted((task_kw or {}).items())))
    init = jax.tree_util.tree_map(np.asarray,
                                  jax_task.model.init(jax.random.PRNGKey(0)))
    final = {}
    run = jax_controller.Controller.run

    def keep_params(self, *args, **kwargs):
        final["params"], result = run(self, *args, **kwargs)
        return final["params"], result

    monkeypatch.setattr(jax_controller.Controller, "run", keep_params)
    jax_experiment.run_experiment(
        jax_task, parts, test_parts,
        _config(jax_experiment, strategy, tmp_path / "jax.jsonl",
                vectorized=True, **kw),
        initial_params=jax.tree_util.tree_map(jnp.asarray, init))
    out = {"jax": final["params"]}
    for name, vectorized in (("vec", True), ("eager", False)):
        task = ClassificationTask(make_cnn(14, 1, 5, 64),
                                  TaskConfig(**task_cfg), device="cpu")
        out[name], _ = experiment.run_experiment(
            task, parts, test_parts,
            _config(experiment, strategy, tmp_path / f"{name}.jsonl",
                    vectorized=vectorized, **kw),
            initial_params=params_from_numpy(init, "cpu"), device="cpu",
            return_params=True)
    return out


@pytest.mark.parametrize("strategy", ["fedavg", "fedlesscan"])
def test_vectorized_experiment_matches_jax_and_eager(tmp_path, monkeypatch,
                                                     strategy):
    before = [k.launches for k in KERNELS]
    params = _run_three(tmp_path, monkeypatch, strategy)
    jax_trace = (tmp_path / "jax.jsonl").read_bytes()
    assert (tmp_path / "vec.jsonl").read_bytes() == jax_trace
    assert (tmp_path / "eager.jsonl").read_bytes() == jax_trace
    got = params_to_numpy(params["vec"])
    for layer in got:
        for name in got[layer]:
            np.testing.assert_allclose(
                got[layer][name], np.asarray(params["jax"][layer][name]),
                rtol=1e-4, atol=1e-4)
    assert [k.launches for k in KERNELS] == before     # no CPU launch


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_vectorized_compressed_experiment_matches_jax(tmp_path, monkeypatch,
                                                      scheme):
    """Compressed FedLesScan through the executor: each batch row is
    encoded in place by encode_flat.  Payload bytes depend only on P, k
    and the chunk count, so the three traces agree byte for byte; the
    params bound is test_torch_experiment.py's for the compressed runs
    (local SGD; the dense 1e-4 plus the largest codec step the port's
    runs took)."""
    steps = []
    if scheme == "int8":
        def int8_encode(x, chunk=256):
            q, scale = port_codecs.int8_encode(x, chunk)
            steps.append(float(scale.max()))       # one code's step
            return q, scale
        monkeypatch.setattr(port_compress, "int8_encode", int8_encode)
    else:
        def topk_encode(x, k):
            steps.append(float(torch.topk(x.abs(), k).values[-1]))  # tau
            return port_codecs.topk_encode(x, k)
        monkeypatch.setattr(port_compress, "topk_encode", topk_encode)
    params = _run_three(tmp_path, monkeypatch, "fedlesscan",
                        task_kw=dict(optimizer="sgd", learning_rate=0.05),
                        compress_scheme=scheme)
    jax_trace = (tmp_path / "jax.jsonl").read_bytes()
    assert b'"compression_ratio"' in jax_trace
    assert (tmp_path / "vec.jsonl").read_bytes() == jax_trace
    assert (tmp_path / "eager.jsonl").read_bytes() == jax_trace
    payloads = [r["payload_bytes"]
                for r in load_jsonl(str(tmp_path / "vec.jsonl"))
                if "payload_bytes" in r]
    assert payloads and payloads == [
        r["payload_bytes"] for r in load_jsonl(str(tmp_path / "jax.jsonl"))
        if "payload_bytes" in r]
    got = params_to_numpy(params["vec"])
    for layer in got:
        for name in got[layer]:
            np.testing.assert_allclose(
                got[layer][name], np.asarray(params["jax"][layer][name]),
                rtol=0, atol=1e-4 + max(steps))
