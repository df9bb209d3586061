"""The sharded train step (launch/sharded.py: ``make_train_step`` placed
on a device mesh by the sharding specs, DTensor as the partitioner)
against the port's unsharded step and the JAX package's steps, on the CPU.

One run of 4 gloo ranks on a (2, 2) ("data", "model") mesh
(tests/torch_sharded_worker.py) checks ``ssd_scan_sharded`` in each of
its layouts against the plain scan, and trains every config of the
registry reduced, sharded and unsharded from the same init: mamba2-130m
(with remat), gemma2-2b and llama4-maverick-400b-a17b for 3 steps, the
other seven for one.  Beside it run one JAX process on 4 forced host
devices (tests/jax_sharded_reference.py: the reference's own jitted
sharded step over a (2, 2) mesh from the port's mamba2-130m init, then
JAX's ``make_train_step`` compiled for the carried-state steps) and
launch/pretrain.py on one rank under ``torch.distributed.run``.  Then:
losses within LOSS_RTOL of the unsharded step's and Adam's moments
within 2·GRAD_REL_L2 relative L2 (a top-1 MoE's router, gradient zero
analytically, shown zero instead); every rank's gathered state
identical; every leaf laid out by ``to_named`` with the local shape
``shard_shape`` gives; the last sharded step held against the unsharded
step and against JAX's ``make_train_step`` from the state before it,
carried across, at the bounds of tests/test_torch_pretrain.py; the
losses against JAX's (2, 2) run; the CLI's checkpoint restored by the
JAX package.  The production meshes' layouts are checked in this process
on meta tensors under the fake process group.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_sharded_worker as worker
from repro.checkpoint import load_pytree as jax_load_pytree
from repro.configs import get_config as jax_get_config
from repro.models import make_train_step as jax_make_train_step
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import PORT_ONLY, get_config, list_architectures
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
from repro_torch.core.flatten import tree_map, tree_paths
from repro_torch.kernels import flash_attention, int8_encode, ssd_scan
from repro_torch.launch.mesh import (AbstractMesh, make_production_mesh,
                                     to_device_mesh)
from repro_torch.launch.pretrain import step_mesh
from repro_torch.launch.specs import _maker
from repro_torch.models import make_train_step
from repro_torch.sharding.rules import (leaves_with_path, opt_specs,
                                        param_specs, place, placements_of,
                                        shard_shape, to_named)
from torch_parity_common import (GRAD_REL_L2, LAYER_TOL, LOSS_RTOL,
                                 ZERO_GRAD, rel_l2)

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
GRAD_FLOOR = 1e-2            # as tests/test_torch_pretrain.py
OTHERS = tuple(a for a in list_architectures()
               if a not in worker.STEPPED and a not in PORT_ONLY)
JAX_ARCH = "mamba2-130m"


def _env(**extra) -> dict:
    return {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu", **extra}


CLI = ("--device", "cpu", "--steps", "4", "--batch", "4", "--seq", "32",
       "--log-every", "2", "--ckpt-every", "2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank run and, beside it, the JAX run and the one-rank CLI run
    (launch/pretrain.py under ``torch.distributed.run``, checkpoints in
    ``cli/``, its output in ``cli.json``): their output directory."""
    out = tmp_path_factory.mktemp("sharded")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "repro_torch.launch.pretrain",
         *CLI, "--ckpt-dir", str(out / "cli")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env())
    cfg = worker.train_config(JAX_ARCH)
    _, init = make_train_step(cfg)
    state = init(torch.Generator().manual_seed(0))
    save_pytree({"state": train_state_to_numpy(state), "batches": {
        str(i): b for i, b in enumerate(worker.batches(cfg, worker.STEPS))}},
        str(out / "jax_in.npz"))
    ref = subprocess.Popen(
        [sys.executable, str(TESTS / "jax_sharded_reference.py"), JAX_ARCH,
         str(out / "jax_in.npz"), str(out), *worker.STEPPED],
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        res = subprocess.run(
            [sys.executable, str(TESTS / "torch_sharded_worker.py"),
             str(out)], env=_env(), capture_output=True, text=True,
            timeout=240)
        assert res.returncode == 0, res.stderr[-4000:]
        # the port's states are written: JAX's carried-state steps go on
        _, err = ref.communicate("\n", timeout=120)
        cli_out, cli_err = cli.communicate(timeout=120)
    finally:
        ref.kill()
        cli.kill()
    assert ref.returncode == 0, err[-4000:]
    (out / "cli.json").write_text(json.dumps(
        {"returncode": cli.returncode, "stdout": cli_out,
         "stderr": cli_err[-3000:]}))
    return out


def _ranks(out: Path) -> list:
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]


def _tree(flat: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of save_pytree's flat keys."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("|")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _saved(out: Path, arch: str) -> dict:
    with np.load(out / f"{arch}.npz") as raw:
        flat = {k: raw[k] for k in raw}
    return {k: _tree(flat, k) for k in ("sharded", "before", "plain",
                                        "batch")}


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _check_moments(got, want, cfg, label):
    """Adam's moments of ``got`` within 2·GRAD_REL_L2 relative L2 of
    ``want``'s (a top-1 router's, zero analytically, shown zero in
    both)."""
    assert int(got["opt"]["count"]) == int(want["opt"]["count"])
    for key in ("m", "v"):
        floor = ZERO_GRAD * max(np.linalg.norm(np.asarray(w, np.float64))
                                for _, w in tree_paths(want["opt"][key]))
        for path, w in tree_paths(want["opt"][key]):
            g = _leaf(got["opt"][key], path)
            assert g.shape == np.shape(w), (label, key, path)
            if cfg.top_k == 1 and path[-1] == "router":
                assert max(np.linalg.norm(g), np.linalg.norm(w)) < floor, \
                    (label, key, path)
            else:
                assert rel_l2(g, w) <= 2 * GRAD_REL_L2, \
                    (label, key, path, rel_l2(g, w))


def _check_step(got, want, cfg, label):
    """One step's state ``got`` against ``want``'s, both from the same
    state, at the bounds of tests/test_torch_pretrain.py: the moments as
    ``_check_moments``, the params within 1e-3·lr where ``want``'s m stands
    above GRAD_FLOOR of its leaf's largest (Adam's first steps are about
    lr·sign(g), which rounding flips where |g| sits at the noise), plus
    one ulp of the param: p + u rounds to p's ulp, and a param of 6.8 has
    one of 4.8e-7 in fp32, above 1e-3·lr (a top-1 router, whose moments
    hold only rounding, is left out)."""
    _check_moments(got, want, cfg, label)
    lr = cfg.learning_rate
    for path, w in tree_paths(want["params"]):
        if cfg.top_k == 1 and path[-1] == "router":
            continue
        m = np.abs(_leaf(want["opt"]["m"], path))
        sure = m > GRAD_FLOOR * m.max()
        assert sure.any(), (label, path)
        w = np.asarray(w)[sure]
        gap = np.abs(_leaf(got["params"], path)[sure] - w)
        bound = 1e-3 * lr + np.spacing(np.abs(w))
        assert (gap <= bound).all(), (label, path, float(gap.max()),
                                      float((gap / bound).max()))


def _check_run(reports, arch):
    """Losses within LOSS_RTOL of the unsharded step's, every rank's
    gathered state identical, every leaf laid out by its spec."""
    for rank, rep in enumerate(reports):
        rec = rep[arch]
        assert rec["layout_errors"] == [], (rank, rec["layout_errors"])
        np.testing.assert_allclose(rec["losses"], rec["plain_losses"],
                                   rtol=LOSS_RTOL)
        assert rec["losses"] == reports[0][arch]["losses"]
    assert len({rep[arch]["digest"] for rep in reports}) == 1


@pytest.mark.parametrize("arch", worker.STEPPED)
def test_sharded_steps_match_unsharded(runs, arch):
    """Three steps sharded and unsharded from the same init: the losses
    and the moments; then the last sharded step against the unsharded
    step from the state before it, at test_torch_pretrain.py's bounds
    (over three steps a param whose first gradient sat at the noise has
    taken its own lr·sign(g) in each run)."""
    reports = _ranks(runs)
    assert len(reports[0][arch]["losses"]) == worker.STEPS
    _check_run(reports, arch)
    cfg = worker.train_config(arch)
    saved = _saved(runs, arch)
    _check_moments(saved["sharded"], saved["plain"], cfg,
                   f"{arch} sharded against unsharded")
    step, _ = make_train_step(cfg)
    before = train_state_from_numpy(saved["before"], device="cpu")
    want, loss = step(before, {k: torch.from_numpy(v)
                               for k, v in saved["batch"].items()})
    np.testing.assert_allclose(reports[0][arch]["losses"][-1], float(loss),
                               rtol=LOSS_RTOL)
    _check_step(saved["sharded"], train_state_to_numpy(want), cfg,
                f"{arch} last sharded step against unsharded")


@pytest.mark.parametrize("arch", OTHERS)
def test_every_config_takes_a_sharded_step(runs, arch):
    reports = _ranks(runs)
    assert len(reports[0][arch]["losses"]) == 1
    _check_run(reports, arch)


@pytest.mark.parametrize("arch", worker.STEPPED)
def test_sharded_step_matches_jax_from_carried_state(runs, arch):
    """The last sharded step against JAX's ``make_train_step`` from the
    sharded state before it, carried across (test_torch_pretrain.py's
    route; jitted in tests/jax_sharded_reference.py beside the 4-rank
    run): loss within LOSS_RTOL, state at that file's bounds."""
    with np.load(runs / f"{arch}_jax.npz") as raw:
        flat = {k: raw[k] for k in raw}
    loss = _ranks(runs)[0][arch]["losses"][-1]
    np.testing.assert_allclose(loss, float(flat["loss"]), rtol=LOSS_RTOL)
    _check_step(_saved(runs, arch)["sharded"], _tree(flat, "state"),
                worker.train_config(arch), f"{arch} sharded against JAX")


@pytest.mark.parametrize("layout", sorted(worker.SCAN_SHAPES))
def test_sharded_scan_layouts_match_plain(runs, layout):
    """``ssd_scan_sharded`` with the heads split over the model axis, the
    head dim p split (the heads do not divide the axis), or nothing split
    (neither does), against ``ssd_scan_plain`` on the whole tensors: y,
    the final state and the grads of x, a_dt, B and C within LAYER_TOL of
    the largest |plain value|, on every rank."""
    for rank, rep in enumerate(_ranks(runs)):
        errors = rep["scan"][layout]
        assert set(errors) == {"y", "state", "x", "a_dt", "B", "C"}
        assert max(errors.values()) <= LAYER_TOL, (rank, errors)


def test_losses_match_the_reference_sharded_step(runs):
    """The port's 4-rank losses against the JAX package's own jitted step
    over a (2, 2) mesh of 4 host devices, from the same state."""
    ref = json.loads((runs / "jax_out.json").read_text())
    assert len(ref["devices"]) == 4
    got = _ranks(runs)[0][JAX_ARCH]["losses"]
    assert len(got) == len(ref["losses"]) == worker.STEPS
    np.testing.assert_allclose(got, ref["losses"], rtol=LOSS_RTOL)


@pytest.fixture
def fake_group():
    """Join a fake process group of the given size (no communication):
    the ranks of a production mesh in one process."""
    def join(world: int, rank: int = 0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield join
    if dist.is_initialized():
        dist.destroy_process_group()


def _meta_state(cfg) -> dict:
    """``make_train_step(cfg)``'s init state as meta tensors (shapes and
    dtypes; no data), drawn on fake tensors as the dry run draws it."""
    _, init = make_train_step(cfg)
    ctx, gen = _maker(None)
    with ctx:
        state = init(gen)

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return {"params": tree_map(meta, state["params"]),
            "opt": {k: v if k == "count" else tree_map(meta, v)
                    for k, v in state["opt"].items()}}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_place_every_config(fake_group, multi_pod):
    """Every config at full size on the (16, 16) and (2, 16, 16) meshes:
    each leaf of the train state, placed by ``to_named`` of its spec, has
    ``shard_shape``'s local shape on a rank inside the mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    fake_group(mesh.size, rank=mesh.size - 3)
    device_mesh = to_device_mesh(mesh, "cpu")
    assert device_mesh.mesh_dim_names == tuple(mesh.shape)
    assert tuple(device_mesh.shape) == tuple(mesh.shape.values())
    for arch in list_architectures():
        state = _meta_state(get_config(arch))
        p_specs = param_specs(state["params"], mesh)
        specs = {"params": p_specs,
                 "opt": opt_specs(state["opt"], p_specs, mesh)}
        placed = place(state, to_named(specs, device_mesh))
        assert placed["opt"]["count"] == 0
        sharded = 0
        for (path, leaf), (_, spec) in zip(leaves_with_path(placed),
                                           leaves_with_path(specs)):
            if not isinstance(leaf, DTensor):
                continue
            assert tuple(leaf.to_local().shape) == shard_shape(
                leaf.shape, spec, mesh), (arch, path, spec)
            sharded += any(spec)
        assert sharded, arch


def test_pretrain_builds_its_mesh_over_256_ranks(fake_group):
    fake_group(256, rank=17)
    device_mesh = step_mesh(True, "cpu")
    assert device_mesh.mesh_dim_names == ("data", "model")
    assert tuple(device_mesh.shape) == (16, 16)
    with pytest.raises(ValueError, match="256"):
        step_mesh(False, "cpu")        # the host mesh is (1, 1)


def test_pretrain_refuses_another_world_size(fake_group):
    fake_group(4)
    with pytest.raises(ValueError, match=r"256 ranks.* has 4"):
        step_mesh(True, "cpu")


def test_placements_of_specs():
    names = ("pod", "data", "model")
    assert placements_of((None, "model"), names) == (
        Replicate(), Replicate(), Shard(1))
    # an entry of several axes splits its dim over each, outer first
    assert placements_of((("pod", "data"), "model"), names) == (
        Shard(0), Shard(0), Shard(1))
    assert placements_of((), names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements_of((("data", "pod"),), names)
    with pytest.raises(ValueError, match="lacks"):
        placements_of(("clients",), names)
    with pytest.raises(ValueError, match="two dims"):
        placements_of(("model", "model"), names)


def test_kernel_wrappers_refuse_dtensors():
    """A DTensor reaching a kernel wrapper raises, on the CPU too: its
    data_ptr() is no device pointer (the scan takes DTensors through its
    local_map region, ssd_scan_sharded)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        device_mesh = to_device_mesh(AbstractMesh((("data", 1),
                                                   ("model", 1))), "cpu")

        def dt(*shape):
            return distribute_tensor(torch.randn(shape), device_mesh,
                                     [Replicate(), Replicate()])
        x, a, bc = dt(1, 8, 2, 4), -dt(1, 8, 2).abs(), dt(1, 8, 2, 4)
        with pytest.raises(TypeError, match="DTensor"):
            ssd_scan(x, a, bc, bc)
        with pytest.raises(TypeError, match="DTensor"):
            ssd_scan(x.to_local(), a, bc.to_local(), bc.to_local())
        q = dt(1, 2, 8, 4)
        with pytest.raises(TypeError, match="DTensor"):
            flash_attention(q, q, q)
        with pytest.raises(TypeError, match="DTensor"):
            int8_encode(dt(512))
    finally:
        dist.destroy_process_group()


def test_one_rank_cli_writes_a_checkpoint_jax_restores(runs):
    """launch/pretrain.py under ``torch.distributed.run`` (one gloo rank, the
    (1, 1) mesh; run beside the 4 ranks): its checkpoint restores into the
    JAX package's train state."""
    res = json.loads((runs / "cli.json").read_text())
    assert res["returncode"] == 0, res["stderr"]
    steps = re.findall(r"^step +(\d+) loss ([\d.]+)", res["stdout"], re.M)
    assert [int(s) for s, _ in steps] == [2, 4]
    assert np.isfinite([float(v) for _, v in steps]).all()
    assert "checkpoints: [2, 4]" in res["stdout"]
    cfg = jax_get_config("mamba2-130m").reduced().replace(efficient_ce=True)
    _, jinit = jax_make_train_step(cfg)
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(jinit,
                                                 jax.random.PRNGKey(1)))
    restored = jax_load_pytree(str(runs / "cli" / "step_00000004.npz"),
                               like)
    assert int(restored["opt"]["count"]) == 4
    # four steps moved the params off the driver's init (seed 0)
    _, init = make_train_step(get_config("mamba2-130m").reduced())
    first = init(torch.Generator().manual_seed(0))["params"]["embed"]
    assert restored["params"]["embed"].shape == tuple(first.shape)
    assert not np.array_equal(restored["params"]["embed"], first.numpy())
