"""Pretraining entry point: the port of the JAX package's launch/pretrain.py.

Trains a decoder of the zoo on a synthetic token stream
(``data.synthetic.make_token_lm``) through ``models.make_train_step``,
with step-tagged checkpoints in the JAX package's npz format, on the card
unless ``--device cpu`` is given.  Mamba blocks run the forward of their
scan in the hand-written ``ssd_scan`` kernel (its backward is the plain
version's).  The reduced config is the default, as in the reference.

  PYTHONPATH=src python -m repro_torch.launch.pretrain --device cpu \\
      --arch mamba2-130m --steps 100 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.pretrain --full \\
      --arch mamba2-130m --steps 20 --batch 8 --seq 4096 --log-every 5

Codebook configs (musicgen-medium) take one stream a codebook: batch row
i, codebook c reads sequence (i·n_cb + c) of the stream.

Started under a process group (``torchrun``, i.e. ``python -m
torch.distributed.run``, which sets ``RANK`` / ``WORLD_SIZE``), the
entry point places its step on a device mesh as the reference jits it with
sharded param, optimizer and batch specs (launch/sharded.py: DTensor over
a ``DeviceMesh``, NCCL on the cards, gloo with ``--device cpu``): the
reference's meshes, ``make_host_mesh()``'s (1, 1), or (16, 16) over
("data", "model") with ``--production-mesh``, which needs 256 ranks (a
``ValueError`` names 256 and the group's size otherwise).  Every rank
runs the same steps on its shards; rank 0 prints and writes the
checkpoints, gathered whole.  Started alone, it runs the plain step.

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc_per_node 1 -m repro_torch.launch.pretrain --full \
      --arch mamba2-130m --steps 2 --batch 2 --seq 1024 --log-every 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..convert import train_state_to_numpy
from ..data.synthetic import make_token_lm
from ..device import resolve_device
from ..models import make_train_step
from .mesh import make_host_mesh, make_production_mesh, to_device_mesh
from .sharded import init_distributed, make_sharded_train_step


def step_mesh(production: bool, device) -> object:
    """The ``DeviceMesh`` this entry point places its step on, over the process
    group's ranks: the (16, 16) production mesh, or the host mesh's
    (1, 1).  Raises ``ValueError`` when the group's size is not the
    mesh's (256 for the production mesh)."""
    mesh = (make_production_mesh() if production
            else make_host_mesh(device=device))
    return to_device_mesh(mesh, device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 mesh (requires 256 ranks)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(learning_rate=args.lr, efficient_ce=True)

    grouped = init_distributed(device)
    try:
        _train(args, cfg, device, grouped)
    finally:
        if grouped:
            dist.destroy_process_group()


def _train(args, cfg, device, grouped: bool) -> None:
    if grouped or args.production_mesh:
        train_step, init_state = make_sharded_train_step(
            cfg, step_mesh(args.production_mesh, device))
    else:
        train_step, init_state = make_train_step(cfg)
    lead = not grouped or dist.get_rank() == 0
    state = init_state(torch.Generator(device=device).manual_seed(0))

    rows = args.batch * max(1, cfg.n_codebooks)
    data = make_token_lm(args.steps * rows * (args.seq + 1) * 2,
                         vocab=cfg.vocab, seq_len=args.seq, seed=0)
    n_seq = data.x.shape[0]
    shape = ((args.batch, cfg.n_codebooks, args.seq) if cfg.n_codebooks
             else (args.batch, args.seq))

    ckpt = (CheckpointManager(args.ckpt_dir) if args.ckpt_dir and lead
            else None)
    losses = []                   # device scalars, read at the log lines
    t0 = time.time()
    for step in range(args.steps):
        idx = (np.arange(rows) + step * rows) % n_seq
        batch = {k: torch.from_numpy(a[idx].reshape(shape)).to(device)
                 for k, a in (("tokens", data.x), ("labels", data.y))}
        state, loss = train_step(state, batch)
        losses.append(loss)
        if lead and (step + 1) % args.log_every == 0:
            seen = torch.stack(losses[-10:]).tolist()
            rate = (step + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step+1:5d} loss {seen[-1]:.4f} "
                  f"(mean10 {np.mean(seen):.4f}) {rate:,.0f} tok/s",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            _save(ckpt, state, step + 1)

    losses = torch.stack(losses).tolist()
    if lead:
        print(f"\nfinal: loss {losses[-1]:.4f} "
              f"(first10 {np.mean(losses[:10]):.4f} → "
              f"last10 {np.mean(losses[-10:]):.4f}) "
              f"in {time.time()-t0:.1f}s")
    if args.ckpt_dir:
        _save(ckpt, state, args.steps)
    if ckpt:
        print(f"checkpoints: {sorted(ckpt.steps())} in {ckpt.dir}")


def _save(ckpt, state, step: int) -> None:
    """Every rank gathers the state (a collective); the lead rank, the one
    holding ``ckpt``, writes it in the JAX package's npz format."""
    host = train_state_to_numpy(state)
    if ckpt:
        ckpt.save(host, step)


if __name__ == "__main__":
    main()
