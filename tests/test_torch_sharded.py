"""The port's sharded paths: the P-sharded merge and the cohort-sharded
executor, on meshes of repeated CPU devices.

A ``launch.mesh.Mesh`` of ``(cpu, cpu)`` runs the sharded code on one
device, as ``--xla_force_host_platform_device_count`` does for the JAX
package.  On the CPU each slab runs the kernels' plain versions, which
take every column's K-sum in the same order whatever the slab, so the
sharded wrappers' outputs equal the unsharded wrappers' bit for bit; the
norm sums per-slab norms squared, so it is held within 1e-6 relative.
The executor trains each slice of the cohort with the same operations as
the unsharded executor, on fewer rows, and is held within 1e-5 (the
convolutions' batched sums may group differently by rows).

One subprocess test holds the port against the JAX package's sharded
wrappers and sharded executor on two forced host devices, with meshes of
``Auto`` axes built in the test (the package's own make_host_mesh /
make_clients_mesh build ``Explicit`` axes, whose final slice raises under
JAX 0.9).  There the JAX sharded wrappers equal the JAX unsharded ones
bit for bit, as the port's do here; across the two packages the
unsharded kernels already differ by the fp32 rounding of the K-sum
(tests/test_torch_fed_agg.py), so the port's sharded outputs are held
against JAX's within those tests' bounds: 1e-6 of Σ_k |c_k·U[k, p]| for
fed_agg, rtol 1e-5 / atol 1e-6 for the fused step, 1e-5 on the norm and
on the executor.
"""
import importlib
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import aggregation, merge
from repro_torch.core.flatten import flatten_params, tree_leaves
from repro_torch.data import make_image_classification
from repro_torch.data.synthetic import ArrayDataset
from repro_torch.fl.client import ClientPool
from repro_torch.fl.executor import VectorizedExecutor
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.kernels.fed_agg import (APPLY_OPTS, _pad_p, fed_agg,
                                         fed_agg_apply, fed_agg_apply_sharded,
                                         fed_agg_sharded)
from repro_torch.launch.mesh import Mesh, make_clients_mesh, make_host_mesh
from repro_torch.models.small import make_cnn
from repro_torch.sharding.rules import CLIENT_AXIS, merge_axes, shard_slices

REPO = Path(__file__).resolve().parents[1]
HYPER = (0.1, 0.8, 0.9, 0.99, 1e-3)          # lr, mix, b1, b2, eps
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _host_mesh(n):
    return Mesh((CPU,) * n, (("data", n), ("model", 1)))


def _clients_mesh(n):
    return Mesh((CPU,) * n, ((CLIENT_AXIS, n),))


def _inputs(K, P, seed):
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.normal(size=(K, P)).astype(np.float32))
    c = torch.from_numpy(rng.random(K).astype(np.float32))
    g, m = (torch.from_numpy(rng.normal(size=P).astype(np.float32))
            for _ in range(2))
    v = torch.from_numpy(rng.random(P).astype(np.float32))
    return u, c, g, m * 0.1, v * 0.1


def test_mesh_construction_and_clamping():
    mesh = _host_mesh(2)
    assert mesh.size == 2 and merge_axes(mesh) == ("data", "model")
    assert [rows for _, rows in shard_slices(4, _clients_mesh(2))] == [
        slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError):
        shard_slices(3, _clients_mesh(2))
    with pytest.raises(ValueError):
        Mesh((CPU,) * 3, (("data", 2),))              # does not fill
    with pytest.raises(ValueError):
        Mesh((CPU,), (("rows", 1),))                  # undeclared axis
    # one CPU exists: asking for more clamps to a size-1 mesh
    assert make_host_mesh(data=4, device="cpu").size == 1
    assert make_host_mesh(model=2, data=2, device="cpu").size == 1
    assert make_clients_mesh(8, device="cpu").size == 1


@pytest.mark.parametrize("n_devices", [2, 3])
@pytest.mark.parametrize("P", [1, 1000, 1001])
def test_fed_agg_sharded_equals_unsharded(n_devices, P):
    u, c, *_ = _inputs(5, P, seed=P)
    mesh = _host_mesh(n_devices)
    for dtype in (torch.float32, torch.bfloat16):
        got = fed_agg_sharded(u.to(dtype), c, mesh)
        want = fed_agg(u.to(dtype), c)
        assert got.dtype == dtype and got.shape == (P,)
        assert torch.equal(got, want)


@pytest.mark.parametrize("opt", APPLY_OPTS)
@pytest.mark.parametrize("P", [1, 1000, 1001])
def test_fed_agg_apply_sharded_equals_unsharded(opt, P):
    args = _inputs(4, P, seed=7 + P)
    for n_devices in (2, 3):
        got = fed_agg_apply_sharded(*args, *HYPER, opt=opt,
                                    mesh=_host_mesh(n_devices))
        want = fed_agg_apply(*args, *HYPER, opt=opt)
        for name, t, w in zip(("out", "m", "v"), got[:3], want[:3]):
            assert t.shape == (P,)
            assert torch.equal(t, w), (opt, P, n_devices, name)
        torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n_devices", [2, 3])
def test_fed_agg_sharded_writes_slabs_into_one_output(n_devices,
                                                      monkeypatch):
    """Each slab's sum goes straight into its slice of one (P_pad,) output
    on the mesh's first device: every slab writes into the same storage at
    its own offset, no torch.cat gathers them, and the result is a view of
    that output equal to the unsharded call's."""
    fa = importlib.import_module("repro_torch.kernels.fed_agg")
    P = 1001
    u, c, *_ = _inputs(5, P, seed=11)
    writes = []
    write = fa._fed_agg_into

    def spy(updates, coeffs, out):
        writes.append((out.untyped_storage().data_ptr(),
                       out.storage_offset(), out.numel()))
        return write(updates, coeffs, out)

    def no_cat(*args, **kwargs):
        raise AssertionError("fed_agg_sharded gathered with torch.cat")

    monkeypatch.setattr(fa, "_fed_agg_into", spy)
    monkeypatch.setattr(torch, "cat", no_cat)
    got = fed_agg_sharded(u, c, _host_mesh(n_devices))
    part = -(-P // n_devices)
    assert [w[1:] for w in writes] == [(i * part, part)
                                       for i in range(n_devices)]
    assert len({w[0] for w in writes}) == 1
    assert got.untyped_storage().data_ptr() == writes[0][0]
    assert torch.equal(got, fed_agg(u, c))


def test_padded_tails_stay_zero():
    """The slabs' padded tails: zero updates, params and moments give
    zero Δ, moments and outputs, so they add nothing to the norm."""
    args = _inputs(3, 1001, seed=2)
    n = 3
    padded = [_pad_p(a, n) for a in args]
    assert padded[0].shape == (3, 1002)
    for opt in APPLY_OPTS:
        out = fed_agg_apply(*padded, *HYPER, opt=opt)
        for t in out[:3]:
            assert float(t[1001]) == 0.0
        want = fed_agg_apply(*args, *HYPER, opt=opt)
        torch.testing.assert_close(out[3], want[3], rtol=1e-6, atol=0.0)


def test_size_one_mesh_is_inert():
    u, c, g, m, v = _inputs(4, 1001, seed=3)
    one = _host_mesh(1)
    assert torch.equal(fed_agg_sharded(u, c, one), fed_agg(u, c))
    for t, w in zip(fed_agg_apply_sharded(u, c, g, m, v, *HYPER, mesh=one),
                    fed_agg_apply(u, c, g, m, v, *HYPER)):
        assert torch.equal(t, w)


def test_sharded_wrappers_count_no_cpu_launch():
    u, c, g, m, v = _inputs(2, 10, seed=4)
    before = (fed_agg_sharded.launches, fed_agg_apply_sharded.launches)
    fed_agg_sharded(u, c, _host_mesh(2))
    fed_agg_apply_sharded(u, c, g, m, v, *HYPER, mesh=_host_mesh(2))
    assert (fed_agg_sharded.launches,
            fed_agg_apply_sharded.launches) == before


@pytest.mark.parametrize("opt", ["sgd", "fedadam"])
def test_merge_pipeline_on_a_mesh(opt):
    """MergePipeline(mesh=) gives the unsharded pipeline's params, on the
    identity path (with and without the anchor row) and the optimizer
    path, over two rounds."""
    rng = np.random.default_rng(11)
    base = {"a": {"w": torch.from_numpy(
        rng.normal(size=(7, 5)).astype(np.float32))},
        "b": torch.from_numpy(rng.normal(size=3).astype(np.float32))}
    updates = [aggregation.ClientUpdate(
        f"c{i}", {"a": {"w": base["a"]["w"] + 0.1 * i},
                  "b": base["b"] - 0.05 * i}, num_samples=10 + i)
        for i in range(3)]
    coeffs = aggregation.fedavg_coefficients(updates)
    cfg = merge.ServerOptConfig(name=opt, lr=0.1 if opt != "sgd" else 1.0)
    plain, sharded = (merge.MergePipeline(cfg),
                      merge.MergePipeline(cfg, mesh=_host_mesh(2)))
    for mix in (1.0, 0.6):
        g_plain = plain.merge(base, updates, coeffs, mix=mix)
        g_shard = sharded.merge(base, updates, coeffs, mix=mix)
        for t, w in zip(tree_leaves(g_shard), tree_leaves(g_plain)):
            assert torch.equal(t, w)
        if opt != "sgd":
            assert sharded.last_update_norm == pytest.approx(
                plain.last_update_norm, rel=1e-6)


# ------------------------------------------------------------ executor
@pytest.fixture(scope="module")
def setup():
    full = make_image_classification(160, image_size=14, n_classes=4,
                                     seed=0)
    parts = {f"c{i}": ArrayDataset(full.x[i * 20:(i + 1) * 20],
                                   full.y[i * 20:(i + 1) * 20])
             for i in range(8)}
    task = ClassificationTask(
        make_cnn(14, 1, 4, 8, "tiny"),
        TaskConfig(epochs=2, batch_size=8, per_sample_time_s=0.05),
        device="cpu")
    pool = ClientPool(task, parts, None, proximal_mu=0.0, seed=0)
    return task, pool, task.init_params(0)


def _group(pool, cids, round_number=0):
    return ([pool.clients[c].dataset for c in cids],
            [pool.client_seed(c, round_number) for c in cids])


def test_cohort_sharded_executor_matches_unsharded(setup):
    task, pool, params = setup
    cids = [f"c{i}" for i in range(5)]           # odd: bucket 8 over 2
    datasets, seeds = _group(pool, cids)
    ex = VectorizedExecutor(task)
    single = ex.run_group(cids, datasets, params, 0.01, seeds)
    for n in (2, 3):                             # buckets 8 and 9
        ex.configure_mesh(_clients_mesh(n))
        sharded = ex.run_group(cids, datasets, params, 0.01, seeds)
        for cid in cids:
            (p_s, l_s), (p_1, l_1) = sharded[cid], single[cid]
            assert abs(l_s - l_1) < 1e-5
            for a, b in zip(tree_leaves(p_s), tree_leaves(p_1)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        batch = ex.run_group_batch(cids, datasets, params, 0.01, seeds)
        assert batch.mat.shape[0] == (8 if n == 2 else 9)
        for i, cid in enumerate(cids):
            torch.testing.assert_close(
                batch.row(i), flatten_params(sharded[cid][0])[0],
                rtol=0, atol=0)
    # per-mesh dispatch accounting: each mesh counts its own signatures
    assert ex.compile_count == 1
    ex.configure_mesh(None)
    assert ex.compile_count == 1 and ex.compile_count_total == 3


def test_size_one_clients_mesh_is_inert(setup):
    task, pool, params = setup
    cids = ["c0", "c1", "c2"]
    datasets, seeds = _group(pool, cids)
    plain = VectorizedExecutor(task).run_group(cids, datasets, params, 0.0,
                                               seeds)
    one = VectorizedExecutor(task, mesh=_clients_mesh(1))
    assert one.mesh is None
    got = one.run_group(cids, datasets, params, 0.0, seeds)
    for cid in cids:
        assert got[cid][1] == plain[cid][1]
        for a, b in zip(tree_leaves(got[cid][0]),
                        tree_leaves(plain[cid][0])):
            assert torch.equal(a, b)


# ------------------------------------------------------------ vs JAX
JAX_SHARDED_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import sys
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np, torch
    assert jax.device_count() == 2
    from jax.sharding import Mesh as JaxMesh
    from repro.data import make_image_classification
    from repro.data.synthetic import ArrayDataset
    from repro.fl.client import ClientPool as JaxPool
    from repro.fl.executor import VectorizedExecutor as JaxExecutor
    from repro.fl.tasks import ClassificationTask as JaxTask
    from repro.fl.tasks import TaskConfig as JaxTaskConfig
    from repro.kernels import fed_agg as jax_agg
    from repro.kernels import fed_agg_apply as jax_apply
    from repro.kernels import fed_agg_apply_sharded as jax_apply_sharded
    from repro.kernels import fed_agg_sharded as jax_agg_sharded
    from repro.models.small import make_cnn as jax_make_cnn
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.flatten import tree_leaves
    from repro_torch.fl.client import ClientPool
    from repro_torch.fl.executor import VectorizedExecutor
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig
    from repro_torch.kernels.fed_agg import (APPLY_OPTS,
                                             fed_agg_apply_sharded,
                                             fed_agg_sharded)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.small import make_cnn

    cpu = torch.device("cpu")
    # Auto-axis meshes (jax.sharding.Mesh), not the package's jax.make_mesh
    host = JaxMesh(np.array(jax.devices()).reshape(2, 1), ("data", "model"))
    port_host = Mesh((cpu, cpu), (("data", 2), ("model", 1)))
    hyper = (0.1, 0.8, 0.9, 0.99, 1e-3)
    rng = np.random.default_rng(0)
    for P in (1001,):                  # ragged: both packages pad it
        u = rng.normal(size=(4, P)).astype(np.float32)
        c = rng.random(4).astype(np.float32)
        g = rng.normal(size=P).astype(np.float32)
        m = (rng.normal(size=P) * 0.1).astype(np.float32)
        v = (rng.random(P) * 0.1).astype(np.float32)
        want = np.asarray(jax_agg_sharded(jnp.asarray(u), jnp.asarray(c),
                                          host))
        assert np.array_equal(want, np.asarray(jax_agg(jnp.asarray(u),
                                                       jnp.asarray(c))))
        got = fed_agg_sharded(torch.from_numpy(u), torch.from_numpy(c),
                              port_host).numpy()
        bound = 1e-6 * np.abs(c[:, None] * u).sum(axis=0)
        assert np.all(np.abs(got - want) <= bound), P
        for opt in APPLY_OPTS:
            arrays = [jnp.asarray(a) for a in (u, c, g, m, v)]
            want = jax_apply_sharded(*arrays, *hyper, opt=opt, mesh=host)
            unsharded = jax_apply(*arrays, *hyper, opt=opt)
            got = fed_agg_apply_sharded(*map(torch.from_numpy,
                                             (u, c, g, m, v)),
                                        *hyper, opt=opt, mesh=port_host)
            for name, t, w, w1 in zip(("out", "m", "v"), got[:3], want[:3],
                                      unsharded[:3]):
                assert np.array_equal(np.asarray(w), np.asarray(w1))
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{P} {opt} {name}")
            np.testing.assert_allclose(float(got[3]), float(want[3]),
                                       rtol=1e-5)

    full = make_image_classification(160, image_size=14, n_classes=4,
                                     seed=0)
    x, y = np.asarray(full.x), np.asarray(full.y)
    parts = {f"c{i}": ArrayDataset(x[i * 20:(i + 1) * 20],
                                   y[i * 20:(i + 1) * 20])
             for i in range(8)}
    cfg = dict(epochs=2, batch_size=8, per_sample_time_s=0.05)
    jax_task = JaxTask(jax_make_cnn(14, 1, 4, 8, "tiny"),
                       JaxTaskConfig(**cfg))
    task = ClassificationTask(make_cnn(14, 1, 4, 8, "tiny"),
                              TaskConfig(**cfg), device="cpu")
    init = jax.tree_util.tree_map(np.asarray,
                                  jax_task.init_params(0))
    cids = [f"c{i}" for i in range(3)]
    seeds = [JaxPool(jax_task, parts, None, seed=0).client_seed(c, 0)
             for c in cids]
    assert seeds == [ClientPool(task, parts, None, seed=0).client_seed(c, 0)
                     for c in cids]
    datasets = [parts[c] for c in cids]
    jax_ex = JaxExecutor(jax_task)
    jax_ex.configure_mesh(JaxMesh(np.array(jax.devices()), ("clients",)))
    want = jax_ex.run_group(cids, datasets,
                            jax.tree_util.tree_map(jnp.asarray, init),
                            0.0, seeds)
    ex = VectorizedExecutor(task)
    ex.configure_mesh(Mesh((cpu, cpu), (("clients", 2),)))
    got = ex.run_group(cids, datasets, params_from_numpy(init, "cpu"), 0.0,
                       seeds)
    for cid in cids:
        assert abs(got[cid][1] - want[cid][1]) < 1e-5, cid
        for a, b in zip(tree_leaves(got[cid][0]),
                        jax.tree_util.tree_leaves(want[cid][0])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
    print("PORT-SHARDED-VS-JAX-OK")
""")


def test_sharded_paths_match_jax_on_two_forced_devices():
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", JAX_SHARDED_SCRIPT],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(REPO), env=env)
    assert "PORT-SHARDED-VS-JAX-OK" in res.stdout, res.stdout + res.stderr


# ------------------------------------------------------------ experiments
def _experiment(tmp_path, name, **kw):
    from repro_torch.data import label_sorted_shards
    from repro_torch.fl import experiment

    full = make_image_classification(300, 14, 5, seed=0)
    train = ArrayDataset(full.x[:250], full.y[:250])
    parts = label_sorted_shards(train, 5, 2)
    task = ClassificationTask(make_cnn(14, 1, 5, 16),
                              TaskConfig(epochs=1, batch_size=16),
                              device="cpu")
    cfg = experiment.ExperimentConfig(
        strategy="fedlesscan", n_rounds=2, clients_per_round=4,
        eval_every=0, seed=1, vectorized=True,
        trace_path=str(tmp_path / f"{name}.jsonl"),
        scenario=experiment.ScenarioConfig(straggler_fraction=0.3,
                                           round_timeout_s=30.0), **kw)
    params, _ = experiment.run_experiment(
        task, parts, None, cfg, initial_params=task.init_params(0),
        device="cpu", return_params=True)
    return params, (tmp_path / f"{name}.jsonl").read_text().splitlines()


def test_experiment_mesh_knobs_clamp_on_one_cpu(tmp_path):
    """merge_devices, executor_devices, executor_warmup and dispatch_timing
    run on the CPU: the meshes clamp to one device, so the run equals the
    plain vectorized run; dispatch timing adds only `dispatch_s`."""
    want, want_trace = _experiment(tmp_path, "plain")
    got, trace = _experiment(tmp_path, "knobs", merge_devices=2,
                             executor_devices=2, executor_warmup=True,
                             dispatch_timing=True)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    timed = [r for r in trace if '"dispatch_s"' in r]
    assert timed
    stripped = []
    for line in trace:
        rec = json.loads(line)
        rec.pop("dispatch_s", None)
        stripped.append(json.dumps(rec, sort_keys=True))
    assert stripped == [json.dumps(json.loads(r), sort_keys=True)
                        for r in want_trace]


def test_experiment_on_two_slot_meshes(tmp_path, monkeypatch):
    """run_experiment with its executor and merger on (cpu, cpu) meshes,
    wired as run_experiment wires them (``configure_mesh``,
    ``merger.mesh``): the same trace byte for byte, and final params
    within 1e-5 of the unsharded vectorized run."""
    from repro_torch.fl import experiment

    want, want_trace = _experiment(tmp_path, "plain")
    monkeypatch.setattr(experiment, "make_host_mesh",
                        lambda data=1, model=1, device=None: _host_mesh(2))
    monkeypatch.setattr(experiment, "make_clients_mesh",
                        lambda clients=1, device=None: _clients_mesh(2))
    calls = []

    def spy(updates, coeffs, mesh):
        calls.append(mesh.size)
        return fed_agg_sharded(updates, coeffs, mesh)

    monkeypatch.setattr(aggregation, "fed_agg_sharded", spy)
    got, trace = _experiment(tmp_path, "sharded", merge_devices=2,
                             executor_devices=2)
    assert calls and set(calls) == {2}          # every merge was sharded
    assert trace == want_trace
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
