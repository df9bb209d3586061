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
            "repro_torch.models.moe, repro_torch.sharding.flash_decode\n"
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
                   "models/moe.py", "sharding/flash_decode.py"):
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
