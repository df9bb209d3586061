"""run_experiment in the training modes and schedulers beyond sync
FedAvg/FedLesScan, in both packages.

FedBuff and FedAsync (async, barrier-free), FedProx (sync, proximal
term), FedLesScan in its semi-async mode and FedAvg under the Apodotiko
scheduler each run 3 rounds on the same data, initial params and seeds
through repro.fl.experiment and its port, the port on the eager loop and
on the vectorized executor.  The virtual-time traces must agree byte for
byte and the final params within 1e-4, the bound of the 3-round
experiments in tests/test_torch_experiment.py and
tests/test_torch_executor.py.  Measured: every case within 1.5e-6 of the
JAX run, except FedLesScan (semi-async) on the executor at 1.7e-5; the
executor's batched convolutions round otherwise than the eager loop's,
and that run's eager loop is within 6e-7.  Local training is SGD: local
Adam divides a near-zero gradient by its own root mean square, so a ReLU
input at 0 turns the fp32 rounding difference between XLA's and
PyTorch's convolutions into a full step (at this seed FedAsync ends
2.4e-4 apart under Adam; ROADMAP Queue 3).
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import label_sorted_shards, make_image_classification
from repro.data.synthetic import ArrayDataset
from repro.fl import controller as jax_controller
from repro.fl import experiment as jax_experiment
from repro.fl.tasks import ClassificationTask as JaxTask
from repro.fl.tasks import TaskConfig as JaxTaskConfig
from repro.models.small import make_cnn as jax_make_cnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl import experiment
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.models.small import make_cnn

N_CLIENTS = 6
SEED = 3
TOL = dict(rtol=1e-4, atol=1e-4)
TASK = dict(epochs=2, batch_size=32, optimizer="sgd", learning_rate=0.05,
            per_sample_time_s=0.05)
# case -> ExperimentConfig overrides
CASES = {
    "fedbuff": dict(strategy="fedbuff"),
    "fedasync": dict(strategy="fedasync"),
    "fedprox": dict(strategy="fedprox", fedprox_mu=0.01),
    "fedlesscan_semi_async": dict(strategy="fedlesscan", mode="semi-async"),
    "fedavg_apodotiko": dict(strategy="fedavg", scheduler="apodotiko"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data():
    full = make_image_classification(600, 14, 5, seed=0)
    train = ArrayDataset(full.x[:500], full.y[:500])
    test = ArrayDataset(full.x[500:], full.y[500:])
    return (label_sorted_shards(train, N_CLIENTS, 2),
            label_sorted_shards(test, N_CLIENTS, 2))


def _config(module, case, trace_path, **kw):
    return module.ExperimentConfig(
        n_rounds=3, clients_per_round=4, eval_every=3, seed=SEED,
        trace_path=str(trace_path),
        scenario=module.ScenarioConfig(straggler_fraction=0.3,
                                       round_timeout_s=30.0),
        **CASES[case], **kw)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One JAX run a case, made on first use: (initial params, result,
    final params, trace bytes)."""
    init = jax.tree_util.tree_map(
        np.asarray, jax_make_cnn(14, 1, 5, 64).init(jax.random.PRNGKey(0)))
    runs = {}

    def run(case):
        if case not in runs:
            parts, test_parts = _data()
            final = {}
            original = jax_controller.Controller.run

            def keep(self, *args, **kwargs):
                final["params"], result = original(self, *args, **kwargs)
                return final["params"], result

            path = tmp_path_factory.mktemp(case) / "jax.jsonl"
            jax_controller.Controller.run = keep
            try:
                res = jax_experiment.run_experiment(
                    JaxTask(jax_make_cnn(14, 1, 5, 64),
                            JaxTaskConfig(**TASK)),
                    parts, test_parts, _config(jax_experiment, case, path),
                    initial_params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                          init))
            finally:
                jax_controller.Controller.run = original
            runs[case] = (init, res, final["params"], path.read_bytes())
        return runs[case]

    return run


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["eager", "vectorized"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mode_matches_jax(tmp_path, jax_runs, case, vectorized):
    init, jax_res, jax_params, jax_trace = jax_runs(case)
    parts, test_parts = _data()
    task = ClassificationTask(make_cnn(14, 1, 5, 64), TaskConfig(**TASK),
                              device="cpu")
    params, res = experiment.run_experiment(
        task, parts, test_parts,
        _config(experiment, case, tmp_path / "torch.jsonl",
                vectorized=vectorized),
        initial_params=params_from_numpy(init, "cpu"), device="cpu",
        return_params=True)
    assert (tmp_path / "torch.jsonl").read_bytes() == jax_trace
    assert res.mode == jax_res.mode
    assert [r.aggregated_updates for r in res.rounds] == \
        [r.aggregated_updates for r in jax_res.rounds]
    got = params_to_numpy(params)
    for layer in got:
        for name in got[layer]:
            np.testing.assert_allclose(got[layer][name],
                                       np.asarray(jax_params[layer][name]),
                                       **TOL)
    assert res.mean_eur == jax_res.mean_eur
    assert res.total_duration_s == jax_res.total_duration_s
