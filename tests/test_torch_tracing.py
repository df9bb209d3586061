"""The port's spans and counters (repro_torch.tracing): off by default and
free there, on through ``enable()``, and inert for the results: a tiny
FedLesScan run through the vectorized executor gives every ``fl.*`` span
in every round, nested as the code nests them, and the same params and
JSONL trace bytes as the run without tracing.
"""
import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.flatten import flatten_params
from repro_torch.data.partition import label_sorted_shards
from repro_torch.data.synthetic import ArrayDataset, make_image_classification
from repro_torch.fl import experiment
from repro_torch.fl.executor import VectorizedExecutor
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.models import make_train_step
from repro_torch.models.small import make_cnn

EPOCHS, BATCH = 2, 32
FL_SPANS = ("fl.round", "fl.aggregate", "fl.stage", "fl.steps",
            "fl.optimizer", "fl.device_wait")


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with tracing off and nothing recorded."""
    tracing.enable(False)
    tracing.drain()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tracing.enable(False)
    tracing.drain()


def test_off_is_one_shared_no_op():
    assert not tracing.enabled()
    first = tracing.span("fl.round", round=0)
    assert tracing.span("fl.steps") is first
    assert tracing.span("not.a.span") is first
    with first:
        tracing.count("fl.local_steps", 5)
    assert tracing.drain() == ([], {})


def test_unregistered_names_raise():
    tracing.enable()
    with pytest.raises(KeyError):
        tracing.span("fl.nothing")
    with pytest.raises(KeyError):
        tracing.count("fl.nothing")
    assert set(tracing.SPANS) >= set(FL_SPANS) | {"train.optimizer",
                                                   "ssd_scan_plain_backward"}
    assert all(tracing.SPANS.values()) and all(tracing.COUNTERS.values())


def test_spans_nest_take_the_round_and_record_the_profiler_range():
    tracing.enable()
    with tracing.span("fl.round", round=4):
        with tracing.span("fl.aggregate"):
            with tracing.span("fl.device_wait"):
                pass
    tracing.enable(False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()       # a recording profiler turns it on
        with tracing.span("train.optimizer", step=2):
            torch.ones(3).add_(1)
    assert not tracing.enabled()
    records, counts = tracing.drain()
    assert counts == {}
    got = [(r.name, r.parent, r.attrs) for r in records]
    assert got == [("fl.device_wait", "fl.aggregate", {"round": 4}),
                   ("fl.aggregate", "fl.round", {"round": 4}),
                   ("fl.round", None, {"round": 4}),
                   ("train.optimizer", None, {"step": 2})]
    assert all(r.start_ns <= r.end_ns for r in records)
    assert any(e.name == "train.optimizer" for e in prof.events())


def _fl_run(tmp_path, name, trace):
    full = make_image_classification(600, 14, 5, seed=0)
    parts = label_sorted_shards(ArrayDataset(full.x[:500], full.y[:500]),
                                6, 2)
    task = ClassificationTask(
        make_cnn(14, 1, 5, 64),
        TaskConfig(epochs=EPOCHS, batch_size=BATCH, per_sample_time_s=0.05),
        device="cpu")
    cfg = experiment.ExperimentConfig(
        strategy="fedlesscan", n_rounds=2, clients_per_round=4, eval_every=0,
        seed=3, vectorized=True, trace_path=str(tmp_path / f"{name}.jsonl"),
        scenario=experiment.ScenarioConfig(straggler_fraction=0.3,
                                           round_timeout_s=30.0))
    init = task.model.init(0)
    tracing.enable(trace)
    try:
        params, _ = experiment.run_experiment(
            task, parts, None, cfg, initial_params=init, device="cpu",
            return_params=True)
    finally:
        tracing.enable(False)
    return params, (tmp_path / f"{name}.jsonl").read_bytes()


def test_fl_round_spans_and_local_steps(tmp_path, monkeypatch):
    steps = []
    real = VectorizedExecutor.run_group_batch

    def group(self, cids, datasets, *args, **kw):
        steps.append(EPOCHS * -(-len(datasets[0]) // BATCH))
        return real(self, cids, datasets, *args, **kw)

    monkeypatch.setattr(VectorizedExecutor, "run_group_batch", group)
    _fl_run(tmp_path, "on", True)
    records, counts = tracing.drain()
    assert counts == {"fl.local_steps": sum(steps)} and steps
    rounds = sorted({r.attrs["round"] for r in records})
    assert rounds == [0, 1]
    for rnd in rounds:
        names = {r.name for r in records if r.attrs.get("round") == rnd}
        assert names == set(FL_SPANS), (rnd, names)
    parent_of = {"fl.round": None, "fl.aggregate": "fl.round",
                 "fl.stage": "fl.round", "fl.steps": "fl.round",
                 "fl.optimizer": "fl.steps", "fl.device_wait": "fl.aggregate"}
    for r in records:
        assert r.parent == parent_of[r.name], r
        if r.parent is None:
            continue
        outer = [p for p in records if p.name == r.parent
                 and p.attrs["round"] == r.attrs["round"]
                 and p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns]
        assert len(outer) == 1, r
    n_opt = sum(r.name == "fl.optimizer" for r in records)
    assert n_opt == sum(steps)


def test_tracing_leaves_params_and_trace_bit_identical(tmp_path):
    on_params, on_trace = _fl_run(tmp_path, "on", True)
    assert tracing.drain()[0]
    off_params, off_trace = _fl_run(tmp_path, "off", False)
    assert tracing.drain() == ([], {})
    assert on_trace == off_trace
    on_flat, off_flat = (flatten_params(p)[0] for p in (on_params,
                                                         off_params))
    assert torch.equal(on_flat, off_flat)


def test_train_step_gives_train_optimizer():
    cfg = get_config("mamba2-130m").reduced().replace(efficient_ce=True)
    step, init_state = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
             for k in ("tokens", "labels")}
    tracing.enable()
    state, _ = step(state, batch)
    tracing.enable(False)
    records, _ = tracing.drain()
    assert [(r.name, r.parent, r.attrs) for r in records] == [
        ("train.optimizer", None, {"step": 0})]
    assert state["opt"]["count"] == 1


def test_train_step_of_a_hybrid_gives_the_moe_spans_and_counters():
    """One make_train_step step of Nemotron-H at a CPU size (the pattern
    ``MEM*E``, 8 experts, top 2, all held), remat block by block: each
    'moe' block opens ``moe`` with ``moe.experts`` inside, in the forward
    pass and in remat's rerun, and the counters count every routed pair
    of each pass (T·k a block and pass when all experts are held) and
    the largest expert's rows."""
    cfg = get_config("nemotron-3-nano-30b-a3b").replace(
        n_layers=5, pattern=("mamba", "moe", "mamba", "attn_only", "moe"),
        d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=16, vocab=64,
        n_experts=8, top_k=2, shared_expert_ff=24, ssm_state=8,
        ssm_head_dim=8, ssm_n_heads=4, ssm_groups=2, ce_chunk=16,
        dtype="float32", remat=True)
    step, init_state = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    tracing.enable()
    step(state, {"tokens": tokens, "labels": tokens})
    tracing.enable(False)
    records, counts = tracing.drain()
    moe = [r for r in records if r.name == "moe"]
    experts = [r for r in records if r.name == "moe.experts"]
    passes = 2                            # the forward and remat's rerun
    assert len(moe) == len(experts) == 2 * passes
    assert all(r.parent == "moe" for r in experts)
    T = tokens.numel()
    assert counts["moe.routed_pairs"] == 2 * passes * T * cfg.top_k
    assert T * cfg.top_k / cfg.n_experts * 2 * passes <= \
        counts["moe.max_expert_rows"] <= 2 * passes * T
    assert {"moe", "moe.experts"} <= set(tracing.SPANS)
    assert {"moe.routed_pairs", "moe.max_expert_rows"} <= \
        set(tracing.COUNTERS)
