"""The kernels' build cache (launch/compile_cache.py), the counterpart of
the JAX package's persistent compilation cache: enabling it moves the
nvcc libraries' build directory, and an experiment with
``compilation_cache_dir`` set runs on the CPU (no kernel is built there)."""
import pytest

from repro_torch.data import label_sorted_shards, make_image_classification
from repro_torch.data.synthetic import ArrayDataset
from repro_torch.fl import experiment
from repro_torch.fl.tasks import ClassificationTask, TaskConfig
from repro_torch.kernels import build
from repro_torch.launch import compile_cache
from repro_torch.models.small import make_cnn


@pytest.fixture(autouse=True)
def _restore_build_dir(monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", build.DEFAULT_BUILD_DIR)


def test_library_path_lies_under_the_enabled_directory(tmp_path):
    assert compile_cache.cache_dir() is None
    assert build.library_path("ssd_scan").parent == build.DEFAULT_BUILD_DIR
    target = tmp_path / "nested" / "cache"
    compile_cache.enable_compilation_cache(str(target))
    assert target.is_dir()
    assert compile_cache.cache_dir() == str(target.resolve())
    for name in ("fed_agg", "compress", "flash_attention", "ssd_scan"):
        path = build.library_path(name)
        assert path.parent == target.resolve()
        assert not path.exists()            # nothing is built on enabling


def test_experiment_with_a_cache_dir_runs_on_the_cpu(tmp_path):
    full = make_image_classification(120, 14, 4, seed=0)
    train = ArrayDataset(full.x[:100], full.y[:100])
    test = ArrayDataset(full.x[100:], full.y[100:])
    task = ClassificationTask(make_cnn(14, 1, 4, 16),
                              TaskConfig(epochs=1, batch_size=32),
                              device="cpu")
    cfg = experiment.ExperimentConfig(
        strategy="fedlesscan", n_rounds=2, clients_per_round=2,
        compilation_cache_dir=str(tmp_path / "cc"))
    res = experiment.run_experiment(task, label_sorted_shards(train, 4, 2),
                                    label_sorted_shards(test, 4, 2), cfg,
                                    device="cpu")
    assert len(res.rounds) == 2
    assert compile_cache.cache_dir() == str((tmp_path / "cc").resolve())
