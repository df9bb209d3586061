"""Each cell's run, at a tiny size on the CPU (the look for a chip
skipped), comes out correct when the program is sound, and not correct
with the timed path broken underneath: a step that returns its state
unchanged, half of each batch left out (the mean over the rest), an
answer altered where it is produced.  (No cell spans chips, so no
exchange between chips can be left out.)  The control, the reference in
the configuration's lower precision, fails a limit at this size too."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import calibrate, harness, tiny  # noqa: E402

FL = ["femnist_cnn.fedlesscan.k64"]
TRAIN = ["mamba2_130m.train.b8s4096"]
SEED = 2 ** 31 + 4321


def _run(cell):
    rec = harness.driver(cell.traffic["kind"]).run(cell, SEED, 0.0, False,
                                                   device="cpu")
    return rec.checks


def _correct(checks):
    return all(c["ok"] for c in checks.values())


@pytest.mark.parametrize("name", FL + TRAIN)
def test_sound_run_is_correct(name):
    checks = _run(tiny.tiny_cell(name))
    assert _correct(checks), checks


def test_one_client_sets_the_worst_not_the_median():
    """The median client's first-step gap stays with the many; the worst
    client's number takes the one that parts."""
    from bench_port.drivers import fl
    per_client = [{"grad_gap": 1e-5 * (1 + i)} for i in range(15)] + \
        [{"grad_gap": 4e-4}]
    got = fl.summarize(per_client, 2e-7)
    assert got["grad_gap"] == 4e-4
    assert got["grad_gap_client_median"] == pytest.approx(8.5e-5)
    assert got["merge_gap"] == 2e-7
    assert "merge_gap" not in fl.summarize(per_client)


# ------------------------------------------------------------- FL faults
def _fl_fault(monkeypatch, fault):
    from repro_torch.fl import executor as ex
    real_train = ex.VectorizedExecutor._train_slices
    real_loss = ex.VectorizedExecutor._masked_loss

    if fault == "unchanged":
        def train_slices(self, global_params, slices, mu):
            (_, losses), = real_train(self, global_params, slices, mu)
            from repro_torch.core.flatten import tree_map
            k = slices[0][1].shape[0]
            return [(tree_map(lambda v: v.detach().unsqueeze(0).expand(
                k, *v.shape).clone(), global_params), losses)]
        monkeypatch.setattr(ex.VectorizedExecutor, "_train_slices",
                            train_slices)
    elif fault == "half_batch":
        def masked_loss(self, params, x, y, m):
            keep = torch.zeros_like(m)
            keep[: max(1, m.shape[0] // 2)] = 1
            return real_loss(self, params, x, y, m * keep)
        monkeypatch.setattr(ex.VectorizedExecutor, "_masked_loss",
                            masked_loss)
    elif fault == "answer":
        def train_slices(self, global_params, slices, mu):
            (stacked, losses), = real_train(self, global_params, slices, mu)
            from repro_torch.core.flatten import tree_map
            return [(tree_map(lambda v: v * 1.05, stacked), losses)]
        monkeypatch.setattr(ex.VectorizedExecutor, "_train_slices",
                            train_slices)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
@pytest.mark.parametrize("name", FL)
def test_fl_fault_is_not_correct(monkeypatch, name, fault):
    _fl_fault(monkeypatch, fault)
    checks = _run(tiny.tiny_cell(name))
    assert not _correct(checks), checks


def test_fl_merge_fault_is_not_correct(monkeypatch):
    from repro_torch.core import merge
    real = merge.aggregate

    def altered(updates, coeffs, mesh=None):
        from repro_torch.core.flatten import tree_map
        return tree_map(lambda v: v * 1.001, real(updates, coeffs, mesh))
    monkeypatch.setattr(merge, "aggregate", altered)
    checks = _run(tiny.tiny_cell(FL[0]))
    assert not checks["merge_gap"]["ok"], checks


# ------------------------------------------------------------- train faults
def _train_fault(monkeypatch, fault):
    from repro_torch import models
    real = models.make_train_step

    def make(cfg):
        step, init = real(cfg)

        def broken(state, batch):
            if fault == "unchanged":
                _, loss = step(state, batch)
                return state, loss
            if fault == "half_batch":
                half = {k: v[: max(1, v.shape[0] // 2)]
                        for k, v in batch.items()}
                return step(state, half)
            new, loss = step(state, batch)
            return new, loss * 1.01
        return broken, init
    monkeypatch.setattr(models, "make_train_step", make)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_not_correct(monkeypatch, name, fault):
    _train_fault(monkeypatch, fault)
    checks = _run(tiny.tiny_cell(name))
    assert not _correct(checks), checks


# ------------------------------------------------------------- control
@pytest.mark.parametrize("name", FL)
def test_fl_control_fails_a_limit(name):
    cell = tiny.tiny_cell(name)
    got = calibrate.fl_readings(cell, SEED, "cpu")["control"]
    checks = harness.judge(got, cell.limits)
    assert not _correct(checks), checks


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails_a_limit(name):
    cell = tiny.tiny_cell(name)
    got = calibrate.train_readings(cell, SEED, "cpu")["control"]
    checks = harness.judge(got, cell.limits)
    assert not _correct(checks), checks
