"""The slice end to end: the quickstart-sized experiment in both packages.

The same data, the same initial params (carried over with
repro_torch.convert) and the same seeds go through
repro.fl.experiment.run_experiment and its port.  The virtual-time traces
must agree byte for byte, the final params within 1e-4 and the final
accuracy within one test sample.

The runs use experiment seed 3.  Local Adam amplifies the fp32 rounding
differences between XLA's and PyTorch's convolutions wherever a ReLU
input sits at 0: one flip there turns a zero gradient into a full Adam
step (about lr = 1e-3).  At seed 0 FedLesScan hits one such flip, and
eight conv2 weights of one nearly dead channel end 1.3e-3 apart while
every other weight agrees within 4e-5.  Seed 3 has no flip in any of the
three dense runs, so the 1e-4 bound measures the port and not the flip.
The compressed runs train with local SGD and state their own bound (see
test_compressed_experiment_matches_jax).
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
from repro.faas.trace import load_jsonl
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import compress as port_compress
from repro_torch.fl import experiment
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.kernels import compress as port_codecs
from repro_torch.kernels import fed_agg, fed_agg_apply
from repro_torch.models.small import make_cnn

N_CLIENTS = 6
SEED = 3


def _data():
    full = make_image_classification(600, 14, 5, seed=0)
    train = ArrayDataset(full.x[:500], full.y[:500])
    test = ArrayDataset(full.x[500:], full.y[500:])
    return (label_sorted_shards(train, N_CLIENTS, 2),
            label_sorted_shards(test, N_CLIENTS, 2))


def _configs(module, strategy, trace_path, **kw):
    return module.ExperimentConfig(
        strategy=strategy, n_rounds=3, clients_per_round=4, eval_every=3,
        seed=SEED, trace_path=str(trace_path),
        scenario=module.ScenarioConfig(straggler_fraction=0.3,
                                       round_timeout_s=30.0), **kw)


def _run_both(tmp_path, monkeypatch, strategy, task_kw=None, **kw):
    parts, test_parts = _data()
    task_cfg = dict(epochs=2, batch_size=32, per_sample_time_s=0.05,
                    **(task_kw or {}))
    jax_model = jax_make_cnn(14, 1, 5, 64)
    init = jax.tree_util.tree_map(np.asarray,
                                  jax_model.init(jax.random.PRNGKey(0)))

    # the reference returns no params: keep what its controller returns
    final = {}
    run = jax_controller.Controller.run

    def keep_params(self, *args, **kwargs):
        final["params"], result = run(self, *args, **kwargs)
        return final["params"], result

    monkeypatch.setattr(jax_controller.Controller, "run", keep_params)
    jax_res = jax_experiment.run_experiment(
        JaxTask(jax_model, JaxTaskConfig(**task_cfg)), parts, test_parts,
        _configs(jax_experiment, strategy, tmp_path / "jax.jsonl", **kw),
        initial_params=jax.tree_util.tree_map(jax.numpy.asarray, init))

    task = ClassificationTask(make_cnn(14, 1, 5, 64), TaskConfig(**task_cfg),
                              device="cpu")
    params, res = experiment.run_experiment(
        task, parts, test_parts,
        _configs(experiment, strategy, tmp_path / "torch.jsonl", **kw),
        initial_params=params_from_numpy(init, "cpu"), device="cpu",
        return_params=True)
    return (jax_res, final["params"]), (res, params)


@pytest.mark.parametrize("strategy", ["fedavg", "fedlesscan"])
def test_experiment_matches_jax(tmp_path, monkeypatch, strategy):
    (jax_res, jax_params), (res, params) = _run_both(tmp_path, monkeypatch,
                                                     strategy)
    assert ((tmp_path / "torch.jsonl").read_bytes()
            == (tmp_path / "jax.jsonl").read_bytes())
    got = params_to_numpy(params)
    for layer in got:
        for name in got[layer]:
            assert params[layer][name].device.type == "cpu"
            np.testing.assert_allclose(got[layer][name],
                                       np.asarray(jax_params[layer][name]),
                                       rtol=1e-4, atol=1e-4)
    # accuracy is the share of correct samples over the sampled test
    # clients: one sample of the smallest client bounds one sample of any
    one_sample = 1.0 / min(len(ds) for ds in _data()[1].values())
    assert abs(res.final_accuracy - jax_res.final_accuracy) <= one_sample
    assert res.mean_eur == jax_res.mean_eur
    assert res.total_duration_s == jax_res.total_duration_s


def test_server_opt_experiment_matches_jax(tmp_path, monkeypatch):
    """FedAdam reaches fed_agg_apply; its traces carry ‖Δ‖₂, which is
    compared at rtol 1e-4, every other field exactly."""
    (jax_res, jax_params), (res, params) = _run_both(
        tmp_path, monkeypatch, "fedavg", server_opt="fedadam",
        server_opt_lr=0.01)
    want = load_jsonl(str(tmp_path / "jax.jsonl"))
    got = load_jsonl(str(tmp_path / "torch.jsonl"))
    assert len(got) == len(want)
    norms = 0
    for g, w in zip(got, want):
        if "update_norm" in w:
            norms += 1
            np.testing.assert_allclose(g.pop("update_norm"),
                                       w.pop("update_norm"), rtol=1e-4)
        assert g == w
    assert norms > 0
    got_params = params_to_numpy(params)
    for layer in got_params:
        for name in got_params[layer]:
            np.testing.assert_allclose(got_params[layer][name],
                                       np.asarray(jax_params[layer][name]),
                                       rtol=1e-4, atol=1e-4)


def _record_codec_steps(monkeypatch, scheme):
    """Wrap the port's codec as core/compress.py calls it, recording the
    largest step each encode can take: the largest int8 scale (one code)
    or the top-k threshold tau (a boundary entry kept or dropped)."""
    steps = []
    if scheme == "int8":
        def int8_encode(x, chunk=256):
            q, scale = port_codecs.int8_encode(x, chunk)
            steps.append(float(scale.max()))
            return q, scale
        monkeypatch.setattr(port_compress, "int8_encode", int8_encode)
    else:
        def topk_encode(x, k):
            steps.append(float(torch.topk(x.abs(), k).values[-1]))
            return port_codecs.topk_encode(x, k)
        monkeypatch.setattr(port_compress, "topk_encode", topk_encode)
    return steps


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compressed_experiment_matches_jax(tmp_path, monkeypatch, scheme):
    """FedLesScan with int8 or top-k@1 % client updates.  Wire sizes
    depend only on P, k and the chunk count, so the traces (payload bytes,
    egress billing, compression ratios) must agree byte for byte.

    Final params: the codecs agree bit for bit on equal inputs
    (test_torch_compress.py), so the runs differ by the convolutions' fp32
    rounding, as the dense runs do, plus any codec decision that rounding
    flips: one int8 code, or one top-k entry at the threshold.  A flip
    moves one decoded value by at most one codec step, and error feedback
    hands it back at that client's next encode.  The bound is therefore
    the dense 1e-4 plus the largest step the port's run took.  Local SGD
    (as tests/test_compression.py trains) keeps a flip where it happened;
    local Adam would turn it into a run-wide drift (at this seed, int8
    leaves 12,927 of conv2's 51,200 weights over 1e-5 apart, up to
    1.5e-3), which measures Adam and not the port."""
    steps = _record_codec_steps(monkeypatch, scheme)
    (jax_res, jax_params), (res, params) = _run_both(
        tmp_path, monkeypatch, "fedlesscan",
        task_kw=dict(optimizer="sgd", learning_rate=0.05),
        compress_scheme=scheme)
    jax_trace = (tmp_path / "jax.jsonl").read_bytes()
    assert b'"compression_ratio"' in jax_trace
    assert (tmp_path / "torch.jsonl").read_bytes() == jax_trace
    assert steps
    bound = 1e-4 + max(steps)
    got = params_to_numpy(params)
    for layer in got:
        for name in got[layer]:
            np.testing.assert_allclose(got[layer][name],
                                       np.asarray(jax_params[layer][name]),
                                       rtol=0, atol=bound)
    one_sample = 1.0 / min(len(ds) for ds in _data()[1].values())
    assert abs(res.final_accuracy - jax_res.final_accuracy) <= one_sample
    assert res.mean_eur == jax_res.mean_eur
    assert res.total_duration_s == jax_res.total_duration_s


def test_unported_knobs_raise():
    """No knob is left unported, so none raises: the port's
    ExperimentConfig has every field of the JAX package's, with the same
    defaults.  ``compilation_cache_dir``, the last that raised, runs an
    experiment on the CPU (tests/test_torch_compile_cache.py)."""
    import dataclasses

    def names(config):
        return {f.name for f in dataclasses.fields(config)}

    assert names(experiment.ExperimentConfig) == \
        names(jax_experiment.ExperimentConfig)
    assert dataclasses.asdict(experiment.ExperimentConfig()) == \
        dataclasses.asdict(jax_experiment.ExperimentConfig())


def test_cpu_run_launches_no_kernel(tmp_path, monkeypatch):
    """On the CPU the merge takes the plain versions: no launch counted."""
    before = (fed_agg.launches, fed_agg_apply.launches)
    parts, test_parts = _data()
    task = ClassificationTask(make_cnn(14, 1, 5, 64),
                              TaskConfig(epochs=1, batch_size=64),
                              device="cpu")
    cfg = experiment.ExperimentConfig(strategy="fedavg", n_rounds=1,
                                      clients_per_round=2)
    res = experiment.run_experiment(task, parts, test_parts, cfg,
                                    device="cpu")
    assert res.rounds and res.rounds[0].aggregated_updates > 0
    assert (fed_agg.launches, fed_agg_apply.launches) == before
