"""The port's training driver and simulated FaaS fleet against the JAX
package and the golden traces.

1. The three store-parity scenarios of tests/fleet_parity_common.py (sync
   FedAvg under the Apodotiko scheduler, semi-async FedLesScan, async
   FedBuff with rotation, 20 clients of which 5 straggle) re-driven
   through the port with a torch work function that returns the same
   pseudo-updates.  The JSONL traces must equal tests/golden/*.jsonl byte
   for byte.  The final params are held to the live JAX run within a
   relative 1e-6 (1 ulp, 9.3e-8 relative, was measured; FedBuff's values
   reach 1.05e4, so an absolute bound would say nothing), never to the
   stored digests, which are stale for the installed JAX (ROADMAP
   Queue 3).
2. ``run_experiment(platforms=...)``: clients assigned round-robin to
   three providers, in both packages; the traces must be byte-identical
   and carry each client's provider.
"""
import json

import jax
import numpy as np
import pytest
import torch

import fleet_parity_common as golden
from repro.data import label_sorted_shards, make_image_classification
from repro.data.synthetic import ArrayDataset
from repro.fl import experiment as jax_experiment
from repro.fl.tasks import ClassificationTask as JaxTask
from repro.fl.tasks import TaskConfig as JaxTaskConfig
from repro.models.small import make_cnn as jax_make_cnn
from repro_torch import core as port_core
from repro_torch import faas as port_faas
from repro_torch.convert import params_from_numpy
from repro_torch.fl import experiment
from repro_torch.fl.controller import TrainingDriver
from repro_torch.fl.scheduler import make_scheduler
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.models.small import make_cnn

REL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _work_fn(cid, params, rnd):
    """fleet_parity_common._work_fn with a torch update: the same float64
    values rounded to float32."""
    idx = int(cid[1:])
    vec = (np.linspace(0.0, 1.0, 8) * (idx + 1) + 0.01 * rnd).astype(
        np.float32)
    dur = 8.0 + (idx % 5) * 1.5
    return port_core.ClientUpdate(cid, {"w": torch.from_numpy(vec)},
                                  10 + idx, rnd), dur


def _run_port_scenario(name: str, seed: int = 0):
    """fleet_parity_common.run_scenario on the port's classes."""
    _, strategy_name, mode, sched_name, rounds = \
        {s[0]: s for s in golden.SCENARIOS}[name]
    ids = golden.IDS
    trace = port_faas.TraceRecorder()
    history = port_core.ClientHistoryDB()
    history.ensure(ids)
    strategy = port_core.make_strategy(
        strategy_name,
        port_core.StrategyConfig(clients_per_round=6, max_rounds=20,
                                 buffer_k=3),
        history, seed=seed)
    platform = port_faas.SimulatedFaaSPlatform(
        port_faas.FaaSConfig(cold_start_median_s=2.0, cold_start_sigma=0.4,
                             perf_variation=(0.9, 1.2), failure_rate=0.05,
                             network_jitter_s=0.5),
        seed=seed, recorder=trace)
    profiles = {cid: port_faas.ClientProfile(slow_factor=p.slow_factor,
                                             crash=p.crash)
                for cid, p in golden.PROFILES.items()}
    invoker = port_faas.MockInvoker(platform, _work_fn, profiles)
    scheduler = (make_scheduler(sched_name, 6, history=history,
                                max_rounds=20, client_ids=ids,
                                timeout_s=30.0, seed=seed)
                 if sched_name else None)
    driver = TrainingDriver(strategy, invoker, golden._StubPool(ids),
                            history, port_faas.CostMeter(trace=trace),
                            round_timeout_s=30.0, eval_every=0, seed=seed,
                            mode=mode, trace=trace, scheduler=scheduler)
    params, _ = driver.run({"w": torch.zeros(8)}, rounds)
    return trace.dumps().encode(), params


def _jax_final_params(name: str, monkeypatch):
    """The live JAX run of the scenario: its trace and final params."""
    final = {}
    run = golden.TrainingDriver.run

    def keep(self, *args, **kwargs):
        final["params"], result = run(self, *args, **kwargs)
        return final["params"], result

    monkeypatch.setattr(golden.TrainingDriver, "run", keep)
    trace, _ = golden.run_scenario(name)
    return trace, np.asarray(final["params"]["w"])


@pytest.mark.parametrize("name", [s[0] for s in golden.SCENARIOS])
def test_golden_scenario_through_port(name, monkeypatch):
    trace, params = _run_port_scenario(name)
    assert trace == (golden.GOLDEN_DIR / f"{name}.jsonl").read_bytes()
    jax_trace, jax_w = _jax_final_params(name, monkeypatch)
    assert trace == jax_trace
    assert params["w"].dtype == torch.float32
    np.testing.assert_allclose(params["w"].numpy(), jax_w, rtol=REL_TOL,
                               atol=0)


# ------------------------------------------------------------ platforms
PLATFORMS = ("gcf-gen2", "aws-lambda", "openfaas")
N_CLIENTS = 6


def _data():
    full = make_image_classification(240, 14, 4, seed=0)
    train = ArrayDataset(full.x[:200], full.y[:200])
    test = ArrayDataset(full.x[200:], full.y[200:])
    return (label_sorted_shards(train, N_CLIENTS, 2),
            label_sorted_shards(test, N_CLIENTS, 2))


TASK = dict(epochs=1, batch_size=16, optimizer="sgd", learning_rate=0.05,
            per_sample_time_s=0.05)
ASSIGNMENT = {f"client_{i}": PLATFORMS[i % len(PLATFORMS)]
              for i in range(N_CLIENTS)}


def _config(module, trace_path, **kw):
    return module.ExperimentConfig(
        strategy="fedlesscan", n_rounds=2, clients_per_round=4,
        eval_every=0, seed=1, trace_path=str(trace_path),
        platforms=ASSIGNMENT,
        scenario=module.ScenarioConfig(straggler_fraction=0.3,
                                       round_timeout_s=30.0), **kw)


@pytest.fixture(scope="module")
def jax_platforms_run(tmp_path_factory):
    """The JAX package's run: its initial params and trace bytes."""
    parts, test_parts = _data()
    assert sorted(parts) == sorted(ASSIGNMENT)
    jax_model = jax_make_cnn(14, 1, 4, 8)
    init = jax.tree_util.tree_map(np.asarray,
                                  jax_model.init(jax.random.PRNGKey(0)))
    path = tmp_path_factory.mktemp("jax") / "trace.jsonl"
    jax_experiment.run_experiment(
        JaxTask(jax_model, JaxTaskConfig(**TASK)), parts, test_parts,
        _config(jax_experiment, path),
        initial_params=jax.tree_util.tree_map(jax.numpy.asarray, init))
    return init, path.read_bytes()


@pytest.mark.parametrize("vectorized", [False, True])
def test_platforms_run_matches_jax(tmp_path, jax_platforms_run, vectorized):
    init, jax_trace = jax_platforms_run
    parts, test_parts = _data()
    task = ClassificationTask(make_cnn(14, 1, 4, 8), TaskConfig(**TASK),
                              device="cpu")
    res = experiment.run_experiment(
        task, parts, test_parts,
        _config(experiment, tmp_path / "torch.jsonl", vectorized=vectorized),
        initial_params=params_from_numpy(init, "cpu"), device="cpu")
    got = (tmp_path / "torch.jsonl").read_bytes()
    assert got == jax_trace
    attempts = [r for r in map(json.loads, got.decode().splitlines())
                if r["type"] == "attempt"]
    assert attempts
    for r in attempts:
        assert r["platform"] == ASSIGNMENT[r["client_id"]]
    assert {r["platform"] for r in attempts} == set(PLATFORMS)
    assert len(res.rounds) == 2
