"""The 4-rank run of tests/test_torch_sharded_train.py (no JAX here).

    PYTHONPATH=src python tests/torch_sharded_worker.py OUT_DIR

spawns 4 gloo ranks over a ``FileStore`` in OUT_DIR, lays a (2, 2)
("data", "model") ``DeviceMesh`` over them and, for each config of the
registry reduced, trains the sharded step (launch/sharded.py) beside the
port's unsharded step from the same init (seed 0) on the same batches:
STEPPED configs for STEPS steps, the others for one.  Each rank writes
``rank<r>.json``: per config, both steps' losses, a digest of its gathered
state, and every leaf whose placements or local shape differ from
``to_named`` / ``shard_shape`` of its spec; under ``scan``,
``ssd_scan_sharded`` against the plain scan in each of its layouts
(``scan_errors``).  Rank 0 also writes
``<arch>.npz`` (save_pytree of a dict): ``sharded`` and ``plain`` (the
final states), ``before`` (the sharded state before the last step, in the
JAX package's train-state layout) and ``batch`` (the last step's).
"""
import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESH = (("data", 2), ("model", 2))
STEPPED = ("mamba2-130m", "gemma2-2b", "llama4-maverick-400b-a17b")
STEPS = 3
B, S = 4, 32
REMAT = ("mamba2-130m",)      # remat (torch.utils.checkpoint) under DTensor
# ssd_scan_sharded's three layouts on the model axis of 2: (b, l, h, p, n)
# with the heads split, the head dim p split (3 heads), nothing split
SCAN_SHAPES = {"heads": (2, 16, 4, 4, 8), "p": (2, 16, 3, 4, 8),
               "none": (2, 16, 3, 3, 8)}


def batches(cfg, steps: int, seed: int = 1) -> list:
    """``steps`` batches of (B, S) ids ((B, n_cb, S) for codebooks) from a
    seed, with image embeddings (normal × 0.1) for a VLM; numpy arrays."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    out = []
    for _ in range(steps):
        b = {"tokens": rng.integers(0, cfg.vocab, shape),
             "labels": rng.integers(0, cfg.vocab, shape)}
        if cfg.n_patches:
            b["image_embeds"] = (rng.normal(size=(B, cfg.n_patches,
                                                  cfg.d_model))
                                 * 0.1).astype(np.float32)
        out.append(b)
    return out


def train_config(arch: str):
    from repro_torch.configs import get_config
    return get_config(arch).reduced().replace(efficient_ce=True,
                                              remat=arch in REMAT)


def _digest(tree) -> str:
    from repro_torch.core.flatten import tree_paths
    h = hashlib.sha256()
    for path, leaf in tree_paths(tree):
        h.update("/".join(path).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _layout_errors(state, mesh, device_mesh) -> list:
    """Leaves whose placements or local shapes are not what their specs
    imply."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import (leaves_with_path, opt_specs,
                                            param_specs, shard_shape,
                                            to_named)
    p_specs = param_specs(state["params"], mesh)
    specs = {"params": p_specs,
             "opt": opt_specs(state["opt"], p_specs, mesh)}
    named = dict(leaves_with_path(to_named(specs, device_mesh)))
    bad = []
    for path, leaf in leaves_with_path(state):
        if not isinstance(leaf, torch.Tensor):
            continue
        sh = named[path]
        local = tuple(leaf.to_local().shape) if isinstance(leaf, DTensor) \
            else None
        if (not isinstance(leaf, DTensor)
                or tuple(leaf.placements) != sh.placements
                or local != shard_shape(leaf.shape, sh.spec, mesh)):
            bad.append("/".join(path))
    return bad


def scan_errors(device_mesh) -> dict:
    """For each of SCAN_SHAPES: ``ssd_scan_sharded`` (batch over data, B
    and C head-broadcast views) against ``ssd_scan_plain`` on the whole
    tensors, forward (y and the final state) and the grads of x, a_dt, B
    and C under one seeded cotangent; each the largest |difference| over
    the largest |plain value|."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.ssd_scan import (ssd_scan_plain,
                                              ssd_scan_sharded)
    errors = {}
    for name, (b, l, h, p, n) in SCAN_SHAPES.items():
        rng = np.random.default_rng(2)

        def draw(*shape):
            return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        inputs = [draw(b, l, h, p),
                  -torch.from_numpy(rng.uniform(0.1, 1.0, (b, l, h))
                                    .astype(np.float32)),
                  draw(b, l, 1, n), draw(b, l, 1, n)]
        gy, gs = draw(b, l, h, p), draw(b, h, p, n)

        def run_scan(scan, x, a, bm, cm):
            y, state = scan(x, a, bm.expand(b, l, h, n),
                            cm.expand(b, l, h, n), chunk=8,
                            return_state=True)
            return y, state

        leaves = [t.clone().requires_grad_() for t in inputs]
        y, state = run_scan(ssd_scan_plain, *leaves)
        want = [y, state, *torch.autograd.grad(
            (y * gy).sum() + (state * gs).sum(), leaves)]
        leaves = [distribute_tensor(t, device_mesh, [Shard(0), Replicate()],
                                    src_data_rank=None).requires_grad_()
                  for t in inputs]
        y, state = (t.full_tensor()
                    for t in run_scan(ssd_scan_sharded, *leaves))
        got = [y, state, *(g.full_tensor() for g in torch.autograd.grad(
            (y * gy).sum() + (state * gs).sum(), leaves))]
        errors[name] = {
            k: float((g - w).detach().abs().max() / w.abs().max())
            for k, g, w in zip(("y", "state", "x", "a_dt", "B", "C"),
                               got, want)}
    return errors


def run(rank: int, world: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(f"{out}/store", world))
    from repro_torch.checkpoint import save_pytree
    from repro_torch.configs import PORT_ONLY, list_architectures
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.launch.mesh import AbstractMesh, to_device_mesh
    from repro_torch.launch.sharded import make_sharded_train_step
    from repro_torch.models import make_train_step

    mesh = AbstractMesh(MESH)
    device_mesh = to_device_mesh(mesh, "cpu")
    report = {"scan": scan_errors(device_mesh)}
    archs = list(STEPPED) + [a for a in list_architectures()
                             if a not in STEPPED and a not in PORT_ONLY]
    for arch in archs:
        cfg = train_config(arch)
        plain_step, plain_init = make_train_step(cfg)
        step, init = make_sharded_train_step(cfg, device_mesh)
        plain = plain_init(torch.Generator().manual_seed(0))
        state = init(torch.Generator().manual_seed(0))
        rec = {"layout_errors": _layout_errors(state, mesh, device_mesh),
               "losses": [], "plain_losses": []}
        data = batches(cfg, STEPS if arch in STEPPED else 1)
        for i, b in enumerate(data):
            # the state before the last step (a gather), saved for STEPPED
            if arch in STEPPED and i == len(data) - 1:
                before = train_state_to_numpy(state)
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            plain, plain_loss = plain_step(plain, tb)
            state, loss = step(state, tb)
            rec["plain_losses"].append(float(plain_loss))
            rec["losses"].append(float(loss))
        rec["layout_errors"] += _layout_errors(state, mesh, device_mesh)
        gathered = train_state_to_numpy(state)
        rec["digest"] = _digest(gathered)
        report[arch] = rec
        if rank == 0 and arch in STEPPED:
            save_pytree({"sharded": gathered, "before": before,
                         "plain": train_state_to_numpy(plain),
                         "batch": data[-1]}, f"{out}/{arch}.npz")
    Path(out, f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    mp.spawn(run, args=(4, out), nprocs=4)
