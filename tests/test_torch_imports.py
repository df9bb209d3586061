"""The port stands alone: no JAX, nothing of the JAX package, and its entry
points run on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.data import make_image_classification
from repro_torch.device import resolve_device
from repro_torch.fl import experiment
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.models.small import make_cnn

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.fl.experiment, "
            "repro_torch.launch.train, repro_torch.convert, "
            "repro_torch.models.transformer, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.fl.executor, "
            "repro_torch.launch.mesh, repro_torch.core.device_batch, "
            "repro_torch.sharding.rules, repro_torch.faas.fleet, "
            "repro_torch.faas.profiles, repro_torch.checkpoint.checkpoint, "
            "repro_torch.fl.checkpointing, repro_torch.launch.pretrain, "
            "repro_torch.optim.optimizers, repro_torch.kernels.ssd_scan, "
            "repro_torch.models.moe, repro_torch.sharding.flash_decode, "
            "repro_torch.examples.quickstart, "
            "repro_torch.examples.straggler_study, "
            "repro_torch.examples.scheduler_study, "
            "repro_torch.examples.async_study, "
            "repro_torch.examples.crash_recovery_smoke, "
            "repro_torch.examples.federated_pretrain, "
            "repro_torch.examples.serve_decode, "
            "repro_torch.launch.specs, repro_torch.launch.variants, "
            "repro_torch.launch.cost_analysis, repro_torch.launch.dryrun, "
            "repro_torch.launch.compile_cache, repro_torch.analysis, "
            "repro_torch.analysis.core, repro_torch.analysis.baseline, "
            "repro_torch.analysis.__main__, repro_torch.analysis.rules, "
            "repro_torch.analysis.rules.determinism, "
            "repro_torch.analysis.rules.torch_safety, "
            "repro_torch.analysis.rules.contracts, "
            "repro_torch.launch.sharded, repro_torch.sharding.spmd, "
            "repro_torch.tracing\n"
            "repro_torch.configs.get_config('nemotron-3-nano-30b-a3b')\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    for module in ("fl/executor.py", "core/device_batch.py",
                   "launch/mesh.py", "sharding/rules.py", "faas/fleet.py",
                   "faas/profiles.py", "checkpoint/checkpoint.py",
                   "fl/checkpointing.py", "launch/pretrain.py",
                   "models/moe.py", "sharding/flash_decode.py",
                   "examples/quickstart.py", "examples/federated_pretrain.py",
                   "examples/serve_decode.py", "launch/specs.py",
                   "launch/variants.py", "launch/cost_analysis.py",
                   "launch/dryrun.py", "launch/compile_cache.py",
                   "analysis/__init__.py", "analysis/core.py",
                   "analysis/baseline.py", "analysis/__main__.py",
                   "analysis/rules/__init__.py",
                   "analysis/rules/determinism.py",
                   "analysis/rules/torch_safety.py",
                   "analysis/rules/contracts.py", "launch/sharded.py",
                   "sharding/spmd.py"):
        assert PORT / module in files, module
    for path in files:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClassificationTask(make_cnn(14, 1, 5, 16), TaskConfig())
    task = ClassificationTask(make_cnn(14, 1, 5, 16), TaskConfig(),
                              device="cpu")
    ds = make_image_classification(20, 14, 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        experiment.run_experiment(task, {"c0": ds}, None,
                                  experiment.ExperimentConfig(n_rounds=1))
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--dataset", "mnist", "--rounds", "1"],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert cli.returncode != 0
    assert "CUDA is not available" in cli.stderr
    pretrain = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.pretrain", "--steps", "1"],
                              capture_output=True, text=True,
                              env={"PYTHONPATH": str(REPO / "src"),
                                   "PATH": "/usr/bin:/bin"})
    assert pretrain.returncode != 0
    assert "CUDA is not available" in pretrain.stderr


# what a reference package's __init__ exports and the port leaves out, why
REFERENCE_PACKAGES = ("analysis", "checkpoint", "configs", "core", "data",
                      "faas", "fl", "kernels", "launch", "models", "optim",
                      "sharding")
NOT_PORTED_PACKAGES: dict = {}
NOT_PORTED = {
    "analysis": {"gates": "the port has no REPRO_* environment switch (no "
                          "path falls back to a plain version on a "
                          "variable's say), so no registry; repro-lint's "
                          "GATE002 keeps it so"},
    "kernels": {"ref": "the *_plain version beside each kernel plays "
                       "kernels/ref.py's role"},
}


def test_reference_package_list_is_complete():
    assert tuple(sorted(p.name for p in (REPO / "src" / "repro").iterdir()
                        if (p / "__init__.py").exists())) == REFERENCE_PACKAGES


@pytest.mark.parametrize("package", REFERENCE_PACKAGES)
def test_port_exports_what_the_reference_exports(package):
    """Every name a reference package exports (its ``__all__``, else the
    public names its ``__init__`` binds) exists in the port's package, or is listed above with
    its reason; a listed name the port has gained must leave the list."""
    import importlib
    import types

    reference = importlib.import_module(f"repro.{package}")
    if package in NOT_PORTED_PACKAGES:
        with pytest.raises(ImportError):
            importlib.import_module(f"repro_torch.{package}")
        return
    ported = importlib.import_module(f"repro_torch.{package}")
    # without __all__: the public names its __init__ binds (submodules
    # that other imports loaded are not exports)
    names = getattr(reference, "__all__", None) or [
        n for n, v in vars(reference).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)]
    skipped = NOT_PORTED.get(package, {})
    assert not [n for n in names if not hasattr(ported, n)
                and n not in skipped]
    assert not [n for n in skipped if hasattr(ported, n)]
    assert set(skipped) <= set(names)


def test_transfer_counters_count_as_the_reference_does():
    """The same executor round in both packages: packaging rebuilds no
    tree, each update's params rebuild one row of P fp32 values, and the
    loss vector crosses to the host once."""
    import jax
    import numpy as np
    from repro.core import device_batch as jax_batch
    from repro.data import make_image_classification as jax_make_data
    from repro.data.synthetic import ArrayDataset
    from repro.fl.client import ClientPool as JaxPool
    from repro.fl.tasks import ClassificationTask as JaxTask
    from repro.fl.tasks import TaskConfig as JaxTaskConfig
    from repro.models.small import make_cnn as jax_make_cnn
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import (pipeline_enabled, reset_transfer_stats,
                                  transfer_stats)
    from repro_torch.fl.client import ClientPool

    full = jax_make_data(60, 14, 3, seed=0)
    parts = {f"c{i}": ArrayDataset(full.x[i * 20:(i + 1) * 20],
                                   full.y[i * 20:(i + 1) * 20])
             for i in range(3)}
    cids = list(parts)
    task_cfg = dict(epochs=1, batch_size=8, per_sample_time_s=0.05)
    jax_task = JaxTask(jax_make_cnn(14, 1, 3, 8), JaxTaskConfig(**task_cfg))
    init = jax.tree_util.tree_map(np.asarray, jax_task.init_params(0))
    task = ClassificationTask(make_cnn(14, 1, 3, 8), TaskConfig(**task_cfg),
                              device="cpu")
    counts = []
    for pool, params, reset, stats in (
            (JaxPool(jax_task, parts, None, seed=0), init,
             jax_batch.reset_transfer_stats, jax_batch.transfer_stats),
            (ClientPool(task, parts, None, seed=0),
             params_from_numpy(init, "cpu"), reset_transfer_stats,
             transfer_stats)):
        reset()
        updates = [u for u, _ in
                   pool.batch_work_fn(cids, params, 0).values()]
        seen = [stats()]
        for u in updates:
            u.params                              # rebuilds the row's tree
        batch = updates[0].batch
        seen.append(stats())
        for i in range(len(cids)):
            batch.loss(i)
        seen.append(stats())
        counts.append(seen)
    assert pipeline_enabled()
    assert counts[1] == counts[0]
    assert counts[0][1]["materialize_rows"] == len(cids)
    assert counts[0][2]["loss_syncs"] == 1
