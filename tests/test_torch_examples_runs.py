"""The port's example CLIs against the JAX package's: async_study,
crash_recovery_smoke and federated_pretrain (tests/test_torch_examples.py
holds the other four, and says how a pair is compared).

async_study runs its sweep columns (``--server-opt``, ``--compression``)
and its twice-run FedBuff trace check; every trace it writes equals the
JAX example's byte for byte, but for the FedAdam runs' ‖Δ‖₂ (a float of
the params, held at rtol 1e-4 as tests/test_torch_experiment.py holds
it).  crash_recovery_smoke SIGKILLs its
checkpointing child (``python -m repro_torch.examples.crash_recovery_smoke
--child``, here started with the JAX package's init params) and resumes
to the clean run's rounds exactly.  federated_pretrain federates reduced
mamba2-130m (the eager loop on the CPU).  Largest accuracy gaps measured:
async_study 0, crash_recovery_smoke 0, federated_pretrain 0.
"""
import json
import re
import subprocess
import types

import jax
import numpy as np
import pytest
import torch

from repro.models import small as jax_small
from repro_torch.examples import (async_study, crash_recovery_smoke,
                                  federated_pretrain)
from torch_parity_common import (assert_outputs_agree, jax_example,
                                 np_tree, run_main, with_jax_init)

VERBOSE_ACC = r"acc=([\d.]+)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny CPU models gain nothing from intra-op threads, and with
    one the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_async_study(monkeypatch, capsys, tmp_path):
    flags = ["--rounds", "2", "--clients", "8", "--cohort", "4",
             "--server-opt", "fedadam", "--compression", "topk"]
    ref = jax_example("async_study")
    monkeypatch.setattr(ref, "OUT", tmp_path / "jax")
    want_rc, want = run_main(monkeypatch, capsys, ref, flags)
    monkeypatch.setattr(async_study, "OUT", tmp_path / "port")
    monkeypatch.setattr(async_study, "make_cnn",
                        with_jax_init(jax_small.make_cnn,
                                      async_study.make_cnn))
    rc, got = run_main(monkeypatch, capsys, async_study,
                       flags + ["--device", "cpu"])
    assert rc == want_rc == 0
    assert "determinism: rerun trace byte-identical = True" in got
    assert_outputs_agree(want, got, [r"^\w+ +\S+ +\S+ +\S+ +([\d.]+) "])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 4 * 3 + 1         # sgd, fedadam, topk; the rerun
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        got_trace = (tmp_path / "port" / name).read_bytes()
        want_trace = (tmp_path / "jax" / name).read_bytes()
        if "fedadam" not in name:
            assert got_trace == want_trace, name
            continue
        # a server optimizer's records carry ‖Δ‖₂, a float of the params:
        # at rtol 1e-4 (tests/test_torch_experiment.py), the rest exactly
        got_rows = [json.loads(r) for r in got_trace.splitlines()]
        want_rows = [json.loads(r) for r in want_trace.splitlines()]
        assert len(got_rows) == len(want_rows)
        for g, w in zip(got_rows, want_rows):
            if "update_norm" in w:
                np.testing.assert_allclose(g.pop("update_norm"),
                                           w.pop("update_norm"), rtol=1e-4)
            assert g == w


# the port's child, started with the JAX package's init params
CHILD = """
import sys
import numpy as np
from repro_torch.convert import params_from_numpy
from repro_torch.examples import crash_recovery_smoke as m
tree = np.load(sys.argv[1], allow_pickle=True).item()
make_cnn = m.make_cnn
m.make_cnn = lambda *a, **k: make_cnn(*a, **k)._replace(
    init=lambda seed=0, device=None: params_from_numpy(tree, device))
sys.argv = ["crash_recovery_smoke", *sys.argv[2:]]
sys.exit(m.main())
"""


def test_crash_recovery_smoke(monkeypatch, capsys, tmp_path):
    ref = jax_example("crash_recovery_smoke")
    want_rc, want = run_main(monkeypatch, capsys, ref,
                             ["--workdir", str(tmp_path / "jax")])
    init = tmp_path / "init.npy"
    np.save(init, np_tree(jax_small.make_cnn(14, 1, 3, 8).init(
        jax.random.PRNGKey(0))), allow_pickle=True)
    spawned = []

    def popen(argv, **kwargs):
        assert argv[1:4] == ["-m", "repro_torch.examples.crash_recovery_smoke",
                             "--child"]
        spawned.append(argv)
        return subprocess.Popen([argv[0], "-c", CHILD, str(init), *argv[3:]],
                                **kwargs)
    monkeypatch.setattr(crash_recovery_smoke, "subprocess",
                        types.SimpleNamespace(Popen=popen))
    monkeypatch.setattr(crash_recovery_smoke, "make_cnn",
                        with_jax_init(jax_small.make_cnn,
                                      crash_recovery_smoke.make_cnn))
    rc, got = run_main(monkeypatch, capsys, crash_recovery_smoke,
                       ["--workdir", str(tmp_path / "port"),
                        "--device", "cpu"])
    assert rc == want_rc == 0
    assert len(spawned) == 1 and spawned[0][-2:] == ["--device", "cpu"]
    assert got.splitlines()[-1].startswith("OK: resumed rounds")
    # how far the child got before the kill is the race's, not the code's
    race = [r"child exited with -?\d+", r"resumed rounds \[[\d, ]*\]"]
    for pattern in race:
        got, want = (re.sub(pattern, "<race>", t) for t in (got, want))
    assert_outputs_agree(want, got, [r"final acc ([\d.]+)\)"])
    report = json.loads((tmp_path / "port" / "report.json").read_text())
    assert report["failures"] == [] and report["resumed_rounds"]
    assert ((tmp_path / "port" / "clean_trace.jsonl").read_bytes()
            == (tmp_path / "jax" / "clean_trace.jsonl").read_bytes())


def test_federated_pretrain(monkeypatch, capsys):
    flags = ["--rounds", "2", "--clients", "4"]
    ref = jax_example("federated_pretrain")
    want_rc, want = run_main(monkeypatch, capsys, ref, flags)
    monkeypatch.setattr(federated_pretrain, "arch_as_model",
                        with_jax_init(ref.arch_as_model,
                                      federated_pretrain.arch_as_model))
    rc, got = run_main(monkeypatch, capsys, federated_pretrain,
                       flags + ["--device", "cpu"])
    assert rc == want_rc == 0
    assert "federated mamba2-130m: final top-1 next-token acc" in got
    assert_outputs_agree(want, got, [VERBOSE_ACC,
                                     r"next-token acc ([\d.]+),"])
