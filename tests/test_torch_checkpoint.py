"""Checkpoint/resume in the port (checkpoint/checkpoint.py,
fl/checkpointing.py) against the JAX package's.

The guarantee is the JAX package's (tests/test_checkpoint_resume.py): a
schema-v2 checkpoint is a full event-queue snapshot, so a resumed run
replays the rest of the timeline byte for byte like an uninterrupted
same-seed run, in-flight stragglers included, in all three training
modes.  The files are the JAX package's, key for key, so a checkpoint
written by either package resumes in the other.  The stub drivers train
nothing: each update is the global params plus a round-dependent step,
on a two-level params tree so that the files' ``|``-joined paths show.
Port and JAX params agree within a relative 1e-6 (the merges' sums may
round 1 ulp apart, as in tests/test_torch_fleet.py); within one package
they are equal.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.faas as jax_faas
import repro_torch.core as port_core
import repro_torch.faas as port_faas
from repro.checkpoint import checkpoint as jax_ckpt
from repro.data import label_sorted_shards, make_image_classification
from repro.data.synthetic import ArrayDataset
from repro.fl import checkpointing as jax_checkpointing
from repro.fl import controller as jax_controller
from repro_torch.checkpoint import checkpoint as port_ckpt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.flatten import tree_leaves, tree_map
from repro_torch.fl import checkpointing, experiment
from repro_torch.fl.controller import TrainingDriver
from repro_torch.fl.scheduler import ApodotikoScheduler
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.models.small import make_cnn

REPO = Path(__file__).resolve().parents[1]
IDS = [f"c{i}" for i in range(8)]
REL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _StubPool:
    def __init__(self, client_ids):
        self._ids = list(client_ids)
        self.clients = {}

    @property
    def client_ids(self):
        return self._ids


PORT = SimpleNamespace(
    core=port_core, faas=port_faas, Driver=TrainingDriver,
    Checkpointer=checkpointing.RoundCheckpointer,
    zeros=lambda: {"layer": {"b": torch.zeros(2), "w": torch.zeros(4)}},
    step=lambda tree, d: tree_map(lambda a: a + d, tree))
JAX = SimpleNamespace(
    core=jax_core, faas=jax_faas, Driver=jax_controller.TrainingDriver,
    Checkpointer=jax_checkpointing.RoundCheckpointer,
    zeros=lambda: {"layer": {"b": jnp.zeros(2), "w": jnp.zeros(4)}},
    step=lambda tree, d: jax.tree_util.tree_map(lambda a: a + d, tree))


def _driver(pkg=PORT, strategy_name="fedlesscan", seed=0, profiles=None,
            trace=None, round_timeout_s=60.0, clients_per_round=3):
    """tests/test_checkpoint_resume.py's stub driver, in either package."""
    def work_fn(cid, params, rnd):
        return (pkg.core.ClientUpdate(cid, pkg.step(params, 0.1 * (rnd + 1)),
                                      10, rnd), 10.0)

    history = pkg.core.ClientHistoryDB()
    history.ensure(IDS)
    strategy = pkg.core.make_strategy(
        strategy_name,
        pkg.core.StrategyConfig(clients_per_round=clients_per_round,
                                max_rounds=10),
        history, seed=seed)
    platform = pkg.faas.SimulatedFaaSPlatform(
        pkg.faas.FaaSConfig(cold_start_median_s=2.0, cold_start_sigma=0.3,
                            perf_variation=(0.9, 1.1), failure_rate=0.0,
                            network_jitter_s=0.4),
        seed=seed, recorder=trace)
    profiles = {cid: pkg.faas.ClientProfile(slow_factor=f)
                for cid, f in (profiles or {}).items()}
    invoker = pkg.faas.MockInvoker(platform, work_fn, profiles)
    return pkg.Driver(strategy, invoker, _StubPool(IDS), history,
                      pkg.faas.CostMeter(trace=trace),
                      round_timeout_s=round_timeout_s, eval_every=0,
                      seed=seed, trace=trace)


def _round_key(stats):
    return (stats.round_number, stats.selected, stats.successes, stats.late,
            stats.crashed, stats.duration_s, stats.eur, stats.cost)


def _lines(recorder):
    return [json.dumps(r, sort_keys=True) for r in recorder.records]


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_same(got, want, rel=0.0):
    for a, b in zip(jax.tree_util.tree_leaves(_np(got)),
                    jax.tree_util.tree_leaves(_np(want))):
        np.testing.assert_allclose(a, b, rtol=rel, atol=0)


# slow enough to miss a 60 s round (10 s work × 8 + cold + jitter ≈ 83 s)
# but to finish mid-flight one or two rounds later
SPAN = {cid: 8.0 for cid in ("c0", "c1", "c2")}


def test_resumed_run_matches_uninterrupted(tmp_path):
    ref = _driver()
    ref_params, ref_res = ref.run(PORT.zeros(), 6)
    first = _driver()
    ckpt = checkpointing.RoundCheckpointer(tmp_path / "ckpt")
    mid_params, _ = first.run(PORT.zeros(), 3, checkpointer=ckpt,
                              checkpoint_every=3)
    assert ckpt.rounds() == [3]
    resumed = _driver()
    params0, next_round = ckpt.restore(resumed, PORT.zeros())
    assert next_round == 3
    _assert_same(params0, mid_params)
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(params0))
    tail_params, tail_res = resumed.run(params0, 6, start_round=next_round)
    assert [_round_key(r) for r in tail_res.rounds] == \
        [_round_key(r) for r in ref_res.rounds[3:]]
    _assert_same(tail_params, ref_params)
    assert resumed.cost.total == pytest.approx(ref.cost.total, abs=1e-12)
    assert resumed.history.to_payload() == ref.history.to_payload()


def _interrupted(tmp_path, pkg_first, pkg_second, strategy_name,
                 profiles=SPAN):
    """``pkg_second``'s uninterrupted 6 rounds against ``pkg_first``'s 2
    rounds, checkpointed, resumed by ``pkg_second``: (reference trace,
    reference params, first trace, resumed trace, resumed params, state,
    reference driver, resumed driver)."""
    ref_trace = pkg_second.faas.TraceRecorder()
    ref = _driver(pkg_second, strategy_name, profiles=profiles,
                  trace=ref_trace)
    ref_params, _ = ref.run(pkg_second.zeros(), 6)
    t1 = pkg_first.faas.TraceRecorder()
    first = _driver(pkg_first, strategy_name, profiles=profiles, trace=t1)
    first.run(pkg_first.zeros(), 2, checkpointer=pkg_first.Checkpointer(
        tmp_path / "ckpt"), checkpoint_every=2)
    t2 = pkg_second.faas.TraceRecorder()
    resumed = _driver(pkg_second, strategy_name, profiles=profiles,
                      trace=t2)
    params0, next_round = pkg_second.Checkpointer(tmp_path / "ckpt").restore(
        resumed, pkg_second.zeros())
    assert next_round == 2
    tail_params, _ = resumed.run(params0, 6, start_round=next_round)
    state = json.loads((tmp_path / "ckpt" / "round_000002.json").read_text())
    return (ref_trace, ref_params, t1, t2, tail_params, state, ref, resumed)


@pytest.mark.parametrize("strategy_name", ["fedlesscan", "fedavg"],
                         ids=["semi_async", "sync"])
def test_barrier_resume_with_inflight_straggler_is_byte_identical(
        tmp_path, strategy_name):
    (ref_trace, ref_params, t1, t2, tail_params, state, ref,
     resumed) = _interrupted(tmp_path, PORT, PORT, strategy_name)
    assert ref.mode == ("semi-async" if strategy_name == "fedlesscan"
                        else "sync")
    # the snapshot really did capture an in-flight straggler
    assert "client_finish" in {ev["kind"] for ev in state["queue"]["events"]}
    assert state["engine"]["rounds"], "no in-flight engine state captured"
    _assert_same(tail_params, ref_params)
    assert _lines(t1) + _lines(t2) == _lines(ref_trace)
    assert resumed.history.to_payload() == ref.history.to_payload()
    assert all(isinstance(k, int) for k in resumed.cost.rounds)
    assert resumed.cost.rounds == ref.cost.rounds
    assert resumed.cost.by_client == ref.cost.by_client


@pytest.mark.parametrize("strategy_name", ["fedasync", "fedbuff"])
def test_async_resume_is_byte_identical(tmp_path, strategy_name):
    """Async snapshots are taken at event horizons (checkpoint_every
    virtual seconds); a restore continues the barrier-free timeline,
    FedBuff's partly filled buffer included."""
    profiles = {"c0": 8.0}
    ck = checkpointing.RoundCheckpointer(tmp_path / "ck", keep=50)
    ref_trace = port_faas.TraceRecorder()
    ref = _driver(PORT, strategy_name, profiles=profiles, trace=ref_trace)
    ref_params, ref_res = ref.run(PORT.zeros(), 4, checkpointer=ck,
                                  checkpoint_every=15.0)
    tags = ck.rounds()
    assert len(tags) >= 2, "expected several event-horizon snapshots"
    tag = tags[len(tags) // 2]
    state = json.loads((tmp_path / "ck" / f"round_{tag:06d}.json")
                       .read_text())
    assert state["async"]["tickets"], "snapshot should hold open tickets"
    t2 = port_faas.TraceRecorder()
    resumed = _driver(PORT, strategy_name, profiles=profiles, trace=t2)
    params0, next_round = ck.restore(resumed, PORT.zeros(),
                                     round_number=tag)
    assert next_round == 0
    tail_params, tail_res = resumed.run(params0, 4)
    _assert_same(tail_params, ref_params)
    assert _lines(t2) == _lines(ref_trace)[state["trace_offset"]:]
    assert [_round_key(r) for r in tail_res.rounds] == \
        [_round_key(r) for r in ref_res.rounds]
    assert resumed.cost.rounds == ref.cost.rounds


def test_async_checkpointer_is_side_effect_free(tmp_path):
    plain = _driver(PORT, "fedasync", profiles={"c0": 8.0})
    p1, r1 = plain.run(PORT.zeros(), 3)
    ck = checkpointing.RoundCheckpointer(tmp_path / "ck", keep=50)
    saving = _driver(PORT, "fedasync", profiles={"c0": 8.0})
    p2, r2 = saving.run(PORT.zeros(), 3, checkpointer=ck,
                        checkpoint_every=10.0)
    _assert_same(p1, p2)
    assert [_round_key(r) for r in r1.rounds] == \
        [_round_key(r) for r in r2.rounds]


# ------------------------------------------------------------ across
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("strategy_name", ["fedlesscan", "fedavg"],
                         ids=["semi_async", "sync"])
def test_cross_framework_resume(tmp_path, direction, strategy_name):
    """A checkpoint written by one package resumes in the other, and the
    two halves of the trace concatenate to the resuming package's
    uninterrupted run."""
    first, second = ((JAX, PORT) if direction == "jax_to_port"
                     else (PORT, JAX))
    (ref_trace, ref_params, t1, t2, tail_params, state, ref,
     resumed) = _interrupted(tmp_path, first, second, strategy_name)
    assert state["engine"]["rounds"]
    assert _lines(t1) + _lines(t2) == _lines(ref_trace)
    _assert_same(tail_params, ref_params, rel=REL_TOL)
    assert resumed.history.to_payload() == ref.history.to_payload()
    assert resumed.cost.rounds == ref.cost.rounds


def test_async_cross_framework_resume(tmp_path):
    """A JAX event-horizon snapshot continues in the port."""
    ck = jax_checkpointing.RoundCheckpointer(tmp_path / "ck", keep=50)
    ref_trace = jax_faas.TraceRecorder()
    ref = _driver(JAX, "fedbuff", profiles={"c0": 8.0}, trace=ref_trace)
    ref_params, _ = ref.run(JAX.zeros(), 4, checkpointer=ck,
                            checkpoint_every=15.0)
    tag = ck.rounds()[len(ck.rounds()) // 2]
    state = json.loads((tmp_path / "ck" / f"round_{tag:06d}.json")
                       .read_text())
    t2 = port_faas.TraceRecorder()
    resumed = _driver(PORT, "fedbuff", profiles={"c0": 8.0}, trace=t2)
    params0, _ = checkpointing.RoundCheckpointer(tmp_path / "ck").restore(
        resumed, PORT.zeros(), round_number=tag)
    tail_params, _ = resumed.run(params0, 4)
    assert _lines(t2) == _lines(ref_trace)[state["trace_offset"]:]
    _assert_same(tail_params, ref_params, rel=REL_TOL)


def test_files_match_jax(tmp_path):
    """The same run saved by both packages: the same json state and the
    same npz keys, values within a relative 1e-6."""
    for pkg, name in ((PORT, "port"), (JAX, "jax")):
        d = _driver(pkg, profiles=SPAN, trace=pkg.faas.TraceRecorder())
        d.run(pkg.zeros(), 2, checkpointer=pkg.Checkpointer(tmp_path / name),
              checkpoint_every=1)
    for tag in (1, 2):
        stem = f"round_{tag:06d}"
        assert (json.loads((tmp_path / "port" / f"{stem}.json").read_text())
                == json.loads((tmp_path / "jax" / f"{stem}.json")
                              .read_text()))
        with np.load(tmp_path / "port" / f"{stem}.npz") as got, \
                np.load(tmp_path / "jax" / f"{stem}.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            assert "params|layer|w" in got.files
            # round 1's straggler is still in flight at tag 2
            assert (tag == 1) != ("extra|engine/1/work/c0|layer|w"
                                  in got.files)
            for key in got.files:
                if key == "_meta":
                    assert str(got[key]) == str(want[key])
                else:
                    assert got[key].dtype == want[key].dtype
                    np.testing.assert_allclose(got[key], want[key],
                                               rtol=REL_TOL, atol=0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pytree_files_cross_load(tmp_path, writer):
    """save_pytree/load_pytree keys: dict keys sorted and joined by ``|``,
    list and tuple positions as ``#i``; each package loads the other's."""
    rng = np.random.default_rng(0)
    tree = {"b": [rng.normal(size=3).astype(np.float32),
                  (np.arange(4, dtype=np.int32),)],
            "a": {"z": rng.normal(size=(2, 2)).astype(np.float32),
                  "y": np.float32(1.5)}}
    path = tmp_path / "t.npz"
    if writer == "port":
        port_tree = {"b": [torch.from_numpy(tree["b"][0]),
                           (torch.from_numpy(tree["b"][1][0]),)],
                     "a": {"z": torch.from_numpy(tree["a"]["z"]),
                           "y": tree["a"]["y"]}}
        port_ckpt.save_pytree(port_tree, str(path))
    else:
        jax_ckpt.save_pytree(jax.tree_util.tree_map(jnp.asarray, tree),
                             str(path))
    with np.load(path) as data:
        assert sorted(data.files) == ["a|y", "a|z", "b|#0", "b|#1|#0"]
    got = port_ckpt.load_pytree(str(path), {
        "b": [torch.zeros(3), (torch.zeros(4, dtype=torch.int32),)],
        "a": {"z": torch.zeros(2, 2), "y": np.float32(0)}})
    want = jax_ckpt.load_pytree(str(path), tree)
    assert isinstance(got["b"][1], tuple)
    assert got["b"][1][0].dtype == torch.int32
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, got,
                                   is_leaf=lambda x: isinstance(
                                       x, torch.Tensor))),
            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape mismatch"):
        port_ckpt.load_pytree(str(path), {
            "b": [torch.zeros(2), (torch.zeros(4),)],
            "a": {"z": torch.zeros(2, 2), "y": np.float32(0)}})


def test_host_arrays_one_copy_a_group(monkeypatch):
    """Tensors of one (device, dtype) cross to the host as one buffer."""
    copies = []
    cpu = torch.Tensor.cpu

    def counted(self, *args, **kwargs):
        copies.append(tuple(self.shape))
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    leaves = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
              torch.ones(4, dtype=torch.int64), torch.full((1,), 7.0),
              np.float32(2.5), torch.tensor(3.0)]
    out = port_ckpt.host_arrays(leaves)
    assert sorted(copies) == [(4,), (8,)]
    for got, leaf in zip(out, leaves):
        want = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        np.testing.assert_array_equal(got, want)
        assert got.shape == np.shape(want)


def test_checkpoint_manager_retention(tmp_path):
    mgr = port_ckpt.CheckpointManager(str(tmp_path / "m"), keep=2)
    for step in (1, 5, 9):
        mgr.save({"w": torch.full((3,), float(step))}, step)
    assert mgr.steps() == [5, 9] and mgr.latest_step() == 9
    assert float(mgr.restore({"w": torch.zeros(3)})["w"][0]) == 9.0
    # the JAX package's manager reads the same directory
    assert jax_ckpt.CheckpointManager(str(tmp_path / "m")).steps() == [5, 9]


# ------------------------------------------------------------ retention
def _save_rounds(d, ckpt, n, accuracies=None):
    params = PORT.zeros()
    for rnd in range(n):
        params, _ = d.run_round(params, rnd)
        if accuracies is not None:
            d._recent_stats[-1].accuracy = accuracies[rnd]
        ckpt.save(d, params, rnd + 1)
    return params


def _names(directory):
    return sorted(p.name for p in Path(directory).iterdir())


@pytest.mark.parametrize("policy,accuracies,want", [
    (dict(keep=2), None, [3, 4]),
    (dict(keep_last_n=1, keep_best=1), [0.2, 0.9, 0.5, 0.1], [2, 4]),
    (dict(keep_last_n=0, keep_best=2), [0.2, 0.9, 0.5, 0.7], [2, 4]),
    (dict(keep_last_n=1, keep_best=1,
          best_metric=lambda driver, params, tag: {1: 5.0, 2: None,
                                                   3: 7.0, 4: None}[tag]),
     None, [3, 4]),
], ids=["keep_last", "keep_best", "best_only", "callable_metric"])
def test_retention(tmp_path, policy, accuracies, want):
    ckpt = checkpointing.RoundCheckpointer(tmp_path / "ckpt", **policy)
    _save_rounds(_driver(), ckpt, 4, accuracies)
    assert ckpt.rounds() == want and ckpt.latest_round() == want[-1]
    # no torn leftovers: every surviving tag has both files
    assert _names(tmp_path / "ckpt") == sorted(
        f"round_{t:06d}.{ext}" for t in want for ext in ("json", "npz"))
    _, next_round = ckpt.restore(_driver(), PORT.zeros(),
                                 round_number=want[0])
    assert next_round == want[0]


def test_retention_keep_best_scores_preexisting_tags_from_disk(tmp_path):
    d = _driver()
    writer = checkpointing.RoundCheckpointer(tmp_path / "ckpt", keep=10,
                                             keep_best=1)
    params = _save_rounds(d, writer, 3, [0.3, 0.8, 0.4])
    later = checkpointing.RoundCheckpointer(tmp_path / "ckpt", keep_last_n=1,
                                            keep_best=1)
    params, _ = d.run_round(params, 3)
    d._recent_stats[-1].accuracy = 0.1
    later.save(d, params, 4)
    assert later.rounds() == [2, 4]


def test_gc_sweeps_orphan_json_from_crashed_gc(tmp_path):
    d = _driver()
    ckpt = checkpointing.RoundCheckpointer(tmp_path / "ckpt", keep=2)
    params = _save_rounds(d, ckpt, 2)
    (tmp_path / "ckpt" / "round_000001.npz").unlink()
    params, _ = d.run_round(params, 2)
    ckpt.save(d, params, 3)
    assert _names(tmp_path / "ckpt") == [
        "round_000002.json", "round_000002.npz",
        "round_000003.json", "round_000003.npz"]


def test_checkpoint_writes_are_atomic(tmp_path, monkeypatch):
    """Both files land through os.replace from a temp name, npz first."""
    replaced = []
    real = os.replace

    def spy(src, dst):
        replaced.append((Path(src).name, Path(dst).name))
        return real(src, dst)

    monkeypatch.setattr(checkpointing.os, "replace", spy)
    ckpt = checkpointing.RoundCheckpointer(tmp_path / "ckpt")
    _save_rounds(_driver(), ckpt, 1)
    assert replaced == [("round_000001.npz.tmp", "round_000001.npz"),
                        ("round_000001.json.tmp", "round_000001.json")]
    assert _names(tmp_path / "ckpt") == ["round_000001.json",
                                         "round_000001.npz"]


def test_restore_rejects_torn_pair(tmp_path):
    ckpt = checkpointing.RoundCheckpointer(tmp_path / "ckpt")
    _save_rounds(_driver(), ckpt, 1)
    spath = tmp_path / "ckpt" / "round_000001.json"
    state = json.loads(spath.read_text())
    state["pair"]["charges"] += 1            # simulate a torn pair
    spath.write_text(json.dumps(state))
    with pytest.raises(ValueError, match="pair mismatch"):
        ckpt.restore(_driver(), PORT.zeros())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_schema_v1_checkpoint_migrates(tmp_path, writer):
    """Schema-v1 checkpoints (no schema field, a params-only npz, the
    strategy_rng key) restore with their round-boundary semantics."""
    d = _driver()
    params, _ = d.run_round(PORT.zeros(), 0)
    state = {
        "mode": d.mode, "strategy": d.strategy.name,
        "scheduler_name": d.scheduler.name,
        "clock": d.queue.clock.now,
        "history": d.history.to_payload(),
        "driver_rng": d.rng.bit_generator.state,
        "strategy_rng": d.strategy.rng.bit_generator.state,
        "scheduler": d.scheduler.state_dict(),
        "cost": {"total": d.cost.total, "invocations": d.cost.invocations,
                 "by_client": dict(d.cost.by_client),
                 "rounds": {str(k): v for k, v in d.cost.rounds.items()}},
        "recent_stats": [], "next_round": 1,
    }
    ckdir = tmp_path / "ckpt"
    ckdir.mkdir()
    if writer == "port":
        port_ckpt.save_pytree(params, str(ckdir / "round_000001.npz"))
    else:
        jax_ckpt.save_pytree(jax.tree_util.tree_map(jnp.asarray,
                                                    params_to_numpy(params)),
                             str(ckdir / "round_000001.npz"))
    (ckdir / "round_000001.json").write_text(json.dumps(state))
    resumed = _driver()
    params0, next_round = checkpointing.RoundCheckpointer(ckdir).restore(
        resumed, PORT.zeros())
    assert next_round == 1
    _assert_same(params0, params)
    assert len(resumed.queue) == 0           # v1: no timeline snapshot
    assert resumed.cost.total == pytest.approx(d.cost.total)
    assert all(isinstance(k, int) for k in resumed.cost.rounds)


def test_restore_rejects_strategy_and_scheduler_mismatch(tmp_path):
    d = _driver(PORT, "fedlesscan")
    ckpt = checkpointing.RoundCheckpointer(tmp_path / "ckpt")
    _save_rounds(d, ckpt, 1)
    with pytest.raises(ValueError, match="strategy"):
        ckpt.restore(_driver(PORT, "fedavg"), PORT.zeros())
    other = _driver(PORT, "fedlesscan")
    other.scheduler = ApodotikoScheduler(3, seed=0)
    with pytest.raises(ValueError, match="scheduler"):
        ckpt.restore(other, PORT.zeros())


# ------------------------------------------------------------ experiments
def _experiment_data():
    full = make_image_classification(400, image_size=14, n_classes=3, seed=0)
    train = ArrayDataset(full.x[:300], full.y[:300])
    test = ArrayDataset(full.x[300:], full.y[300:])
    return (label_sorted_shards(train, 8, 2, seed=0),
            label_sorted_shards(test, 8, 2, seed=0))


def _experiment_config(module=experiment, **kw):
    return module.ExperimentConfig(
        **{"strategy": "fedlesscan", "n_rounds": 4, "clients_per_round": 4,
           "eval_every": 0, "seed": 0, **kw},
        # a slow client misses the 12 s deadline and arrives a round or
        # two later, so each snapshot holds an update in flight
        scenario=module.ScenarioConfig(straggler_fraction=0.3,
                                       slow_factor=6.0,
                                       round_timeout_s=12.0, seed=0))


def _task():
    return ClassificationTask(
        make_cnn(14, 1, 3, 16),
        TaskConfig(epochs=1, batch_size=32, optimizer="sgd",
                   learning_rate=0.05, per_sample_time_s=0.05),
        device="cpu")


@pytest.mark.parametrize("vectorized", [False, True],
                         ids=["eager", "vectorized"])
def test_experiment_resume_surface(tmp_path, vectorized):
    """ExperimentConfig.checkpoint_dir writes round-tagged checkpoints and
    resume_from replays the remaining rounds exactly, on the eager loop
    and on the executor, whose updates are rows of its matrix until the
    snapshot builds their trees."""
    parts, test_parts = _experiment_data()
    init = _task().init_params(0)
    kw = dict(vectorized=vectorized)
    ref_params, ref = experiment.run_experiment(
        _task(), parts, test_parts,
        _experiment_config(trace_path=str(tmp_path / "ref.jsonl"), **kw),
        initial_params=init, device="cpu", return_params=True)
    ckdir = str(tmp_path / "ck")
    experiment.run_experiment(
        _task(), parts, test_parts,
        _experiment_config(n_rounds=2, checkpoint_dir=ckdir,
                           checkpoint_every=1,
                           trace_path=str(tmp_path / "first.jsonl"), **kw),
        initial_params=init, device="cpu")
    state = json.loads((Path(ckdir) / "round_000002.json").read_text())
    assert any(r["work"] for r in state["engine"]["rounds"])
    tail_params, tail = experiment.run_experiment(
        _task(), parts, test_parts,
        _experiment_config(resume_from=ckdir,
                           trace_path=str(tmp_path / "tail.jsonl"), **kw),
        initial_params=init, device="cpu", return_params=True)
    assert [r.round_number for r in tail.rounds] == [2, 3]
    assert [_round_key(r) for r in tail.rounds] == \
        [_round_key(r) for r in ref.rounds[2:]]
    assert tail.final_accuracy == ref.final_accuracy
    _assert_same(tail_params, ref_params)
    # the tail trace continues where the checkpointed run stopped
    ref_lines = (tmp_path / "ref.jsonl").read_text().splitlines()
    first = (tmp_path / "first.jsonl").read_text().splitlines()
    assert (tmp_path / "tail.jsonl").read_text().splitlines() == \
        ref_lines[state["trace_offset"]:]
    assert first[:state["trace_offset"]] == ref_lines[:state["trace_offset"]]


def test_executor_snapshot_saves_the_eager_trees(tmp_path):
    """The executor's cached in-flight updates are saved as the trees the
    eager loop saves: the same keys, values within 1e-5 (the batched
    convolutions round otherwise; local SGD)."""
    parts, test_parts = _experiment_data()
    init = _task().init_params(0)
    for vectorized in (False, True):
        experiment.run_experiment(
            _task(), parts, test_parts,
            _experiment_config(n_rounds=2, checkpoint_dir=str(
                tmp_path / str(vectorized)), checkpoint_every=2,
                vectorized=vectorized),
            initial_params=init, device="cpu")
    with np.load(tmp_path / "False" / "round_000002.npz") as eager, \
            np.load(tmp_path / "True" / "round_000002.npz") as vec:
        assert sorted(eager.files) == sorted(vec.files)
        work = [k for k in eager.files if "/work/" in k]
        assert work, "no cached client update in the snapshot"
        for key in eager.files:
            if key != "_meta":
                np.testing.assert_allclose(vec[key], eager[key], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_experiment_cross_framework_resume(tmp_path, direction):
    """run_experiment checkpoints of the CNN resume in the other package:
    the tail's rounds equal the resuming package's uninterrupted run."""
    from repro.fl import experiment as jax_experiment
    from repro.fl.tasks import ClassificationTask as JaxTask
    from repro.fl.tasks import TaskConfig as JaxTaskConfig
    from repro.models.small import make_cnn as jax_make_cnn

    parts, test_parts = _experiment_data()
    task_kw = dict(epochs=1, batch_size=32, optimizer="sgd",
                   learning_rate=0.05, per_sample_time_s=0.05)
    init = jax.tree_util.tree_map(
        np.asarray, jax_make_cnn(14, 1, 3, 16).init(jax.random.PRNGKey(0)))

    def run(pkg, **kw):
        if pkg == "jax":
            return jax_experiment.run_experiment(
                JaxTask(jax_make_cnn(14, 1, 3, 16), JaxTaskConfig(**task_kw)),
                parts, test_parts, _experiment_config(jax_experiment, **kw),
                initial_params=jax.tree_util.tree_map(jnp.asarray, init))
        return experiment.run_experiment(
            ClassificationTask(make_cnn(14, 1, 3, 16), TaskConfig(**task_kw),
                               device="cpu"),
            parts, test_parts, _experiment_config(**kw),
            initial_params=params_from_numpy(init, "cpu"), device="cpu")

    first, second = (("jax", "port") if direction == "jax_to_port"
                     else ("port", "jax"))
    ckdir = str(tmp_path / "ck")
    run(first, n_rounds=2, checkpoint_dir=ckdir, checkpoint_every=1)
    ref = run(second)
    tail = run(second, resume_from=ckdir)
    assert [r.round_number for r in tail.rounds] == [2, 3]
    for got, want in zip(tail.rounds, ref.rounds[2:]):
        assert _round_key(got) == _round_key(want)


# ------------------------------------------------------------ crash
CHILD = textwrap.dedent("""
    import sys
    import torch
    sys.path.insert(0, {tests!r})
    import test_torch_checkpoint as t
    torch.set_num_threads(1)
    parts, test_parts = t._experiment_data()
    t.experiment.run_experiment(
        t._task(), parts, test_parts,
        t._experiment_config(n_rounds=12, checkpoint_dir={ckdir!r},
                             checkpoint_every=2),
        initial_params=t._task().init_params(0), device="cpu")
""")


def test_crash_and_resume_subprocess(tmp_path):
    """examples/crash_recovery_smoke.py on the port: a child process
    trains with checkpointing and is SIGKILLed once a checkpoint pair is
    on disk; the resumed run replays the clean run's rounds exactly."""
    ckdir = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD.format(tests=str(REPO / "tests"),
                                            ckdir=str(ckdir))],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and proc.poll() is None:
            pairs = ({p.stem for p in ckdir.glob("round_*.json")}
                     & {p.stem for p in ckdir.glob("round_*.npz")})
            if pairs:
                break
            time.sleep(0.05)
        else:
            if proc.poll() is None:
                pytest.fail("no checkpoint within 120 s")
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode in (0, -signal.SIGKILL), proc.stderr.read()
    proc.stderr.close()
    parts, test_parts = _experiment_data()
    clean = experiment.run_experiment(
        _task(), parts, test_parts, _experiment_config(n_rounds=12),
        initial_params=_task().init_params(0), device="cpu")
    resumed = experiment.run_experiment(
        _task(), parts, test_parts,
        _experiment_config(n_rounds=12, resume_from=str(ckdir)),
        initial_params=_task().init_params(0), device="cpu")
    assert resumed.rounds, "the child ran to its end before the kill"
    clean_by_round = {r.round_number: r for r in clean.rounds}
    for r in resumed.rounds:
        assert _round_key(r) == _round_key(clean_by_round[r.round_number])
    assert resumed.final_accuracy == clean.final_accuracy
