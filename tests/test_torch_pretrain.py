"""The port's train step and pretraining CLI against the JAX package.

One ``make_train_step`` step of the port and of the reference, from the
same train state carried across (``convert.train_state_from_numpy``),
on reduced mamba2-130m and gemma2-2b; the pretrain CLI
(``python -m repro_torch.launch.pretrain``) in a subprocess on the CPU;
and its checkpoints read by the JAX package's ``load_pytree`` into a JAX
train state, and the reverse.

Adam's first step is about lr·sign(g): where |g| sits at the rounding
noise a sign flip moves a param by a full lr, so the step's params are
compared only where |g| is above GRAD_FLOOR of the leaf's largest, and
the moments m and v directly (tolerances of tests/torch_parity_common.py).
"""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.configs import get_config as jax_get_config
from repro.models import make_train_step as jax_make_train_step
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.core.flatten import tree_paths
from repro_torch.models import make_train_step
from torch_parity_common import (GRAD_REL_L2, LOSS_RTOL,
                                 assert_trees_rel_l2, lm_batch, np_tree)

REPO = Path(__file__).resolve().parents[1]
GRAD_FLOOR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU models gain nothing from intra-op threads, and with one
    the suite's parallel workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-2b"])
def test_train_step_matches_reference_from_carried_state(arch):
    jcfg = jax_get_config(arch).reduced().replace(efficient_ce=True)
    cfg = get_config(arch).reduced().replace(efficient_ce=True)
    jstep, jinit = jax_make_train_step(jcfg)
    step, _ = make_train_step(cfg)
    jstate = jinit(jax.random.PRNGKey(0))
    state = train_state_from_numpy(np_tree(jstate), device="cpu")
    assert state["opt"]["count"] == 0
    batch = lm_batch(cfg, seed=3)
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_state, want_loss = jax.jit(jstep)(jstate, jbatch)
    new_state, loss = step(state, tbatch)
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert new_state["opt"]["count"] == int(want_state["opt"]["count"]) == 1
    # m = 0.1·g and v = 0.001·g² after the first step
    for key in ("m", "v"):
        assert_trees_rel_l2(new_state["opt"][key], want_state["opt"][key],
                            2 * GRAD_REL_L2)
    want = np_tree(want_state)
    m_ref = want["opt"]["m"]
    lr = cfg.learning_rate
    for path, p in tree_paths(new_state["params"]):
        g = np.abs(_leaf(m_ref, path))
        sure = g > GRAD_FLOOR * g.max()
        assert sure.any(), path
        np.testing.assert_allclose(p.numpy()[sure],
                                   _leaf(want["params"], path)[sure],
                                   rtol=0, atol=1e-3 * lr, err_msg=str(path))
    # the carried state and the JAX state hold the same step afterwards
    back = train_state_to_numpy(new_state)
    assert back["opt"]["count"].dtype == np.int32


def _run_pretrain(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.pretrain", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})


def test_pretrain_cli_trains_and_checkpoints_for_jax(tmp_path):
    res = _run_pretrain("--device", "cpu", "--arch", "mamba2-130m",
                        "--steps", "20", "--batch", "8", "--seq", "64",
                        "--log-every", "5", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "10")
    assert res.returncode == 0, res.stderr[-2000:]
    steps = re.findall(r"^step +(\d+) loss ([\d.]+) \(mean10 ([\d.]+)\) "
                       r"[\d,]+ tok/s$", res.stdout, re.M)
    assert [int(s[0]) for s in steps] == [5, 10, 15, 20]
    final = re.search(r"final: loss ([\d.]+) \(first10 ([\d.]+) → last10 "
                      r"([\d.]+)\)", res.stdout)
    first10, last10 = float(final.group(2)), float(final.group(3))
    assert np.isfinite([first10, last10]).all()
    assert last10 < first10
    assert "checkpoints: [10, 20]" in res.stdout

    # the JAX package reads the port's checkpoint into its train state
    cfg = jax_get_config("mamba2-130m").reduced().replace(efficient_ce=True,
                                                          learning_rate=3e-4)
    jstep, jinit = jax_make_train_step(cfg)
    like = np_tree(jinit(jax.random.PRNGKey(1)))
    path = tmp_path / "step_00000020.npz"
    restored = jax_load_pytree(str(path), like)
    assert int(restored["opt"]["count"]) == 20
    with np.load(path) as raw:
        assert raw["opt|count"].dtype == np.int32
        np.testing.assert_array_equal(restored["params"]["embed"],
                                      raw["params|embed"])
    assert not np.array_equal(restored["params"]["embed"],
                              like["params"]["embed"])
    batch = lm_batch(cfg, B=2, S=64, seed=5)
    _, loss = jax.jit(jstep)(restored, {k: jnp.asarray(v, jnp.int32)
                                        for k, v in batch.items()})
    assert np.isfinite(float(loss))


def test_port_reads_a_jax_train_checkpoint(tmp_path):
    arch = "mamba2-130m"
    jcfg = jax_get_config(arch).reduced().replace(efficient_ce=True)
    cfg = get_config(arch).reduced().replace(efficient_ce=True)
    jstep, jinit = jax_make_train_step(jcfg)
    batch = lm_batch(cfg, seed=4)
    jstate, _ = jax.jit(jstep)(jinit(jax.random.PRNGKey(0)),
                               {k: jnp.asarray(v, jnp.int32)
                                for k, v in batch.items()})
    JaxCheckpointManager(str(tmp_path)).save(jstate, 1)

    step, init_state = make_train_step(cfg)
    template = init_state(torch.Generator().manual_seed(0))
    raw = load_pytree(str(tmp_path / "step_00000001.npz"),
                      train_state_to_numpy(template))
    state = train_state_from_numpy(raw, device="cpu")
    assert state["opt"]["count"] == 1
    want = np_tree(jstate)
    for path, leaf in tree_paths({"params": state["params"],
                                  "m": state["opt"]["m"],
                                  "v": state["opt"]["v"]}):
        src = want["params"] if path[0] == "params" else want["opt"][path[0]]
        np.testing.assert_array_equal(leaf.numpy(), _leaf(src, path[1:]))
    _, loss = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(loss))


def test_production_mesh_needs_256_ranks():
    """--production-mesh on one rank (no process group) raises the
    ValueError that names the 256 ranks the (16, 16) mesh needs."""
    res = _run_pretrain("--device", "cpu", "--production-mesh")
    assert res.returncode != 0
    assert "ValueError" in res.stderr and "256 ranks" in res.stderr
    assert "NotImplementedError" not in res.stderr
