"""Federate an assigned architecture: a reduced mamba2 / gemma2 variant is
the FL payload — FedLesScan schedules clients whose local task is
next-token prediction on private token streams.

This is the bridge between the paper's orchestration layer and the
assigned-architecture model zoo: the same Strategy/controller/FaaS stack,
with the transformer train step as Client_Update's workload.  On the card
a cohort trains through the vectorized executor, so every Mamba block's
scan runs in the ``ssd_scan`` kernel under ``torch.func.vmap``.  The port
of the JAX package's examples/federated_pretrain.py.

    PYTHONPATH=src python -m repro_torch.examples.federated_pretrain \
        --arch mamba2-130m [--device cpu]
"""
import argparse
from typing import Optional

import numpy as np
import torch

from ..configs import get_config
from ..data.synthetic import ArrayDataset, make_token_lm
from ..device import resolve_device
from ..fl.experiment import ExperimentConfig, ScenarioConfig, run_experiment
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models import forward, init_params
from ..models.config import ArchConfig
from ..models.small import ModelDef


def cfg_as_model(cfg: ArchConfig, name: str) -> ModelDef:
    """``cfg`` as a next-token classifier (predict the token at the last
    position); ``init(seed, device)`` draws its params on ``device``."""

    def init(seed: int = 0, device: Optional[torch.device] = None):
        dev = resolve_device(device)
        return init_params(cfg, torch.Generator(device=dev).manual_seed(seed))

    def apply(params, tokens):                       # (B, S) → (B, vocab)
        logits = forward(cfg, params, {"tokens": tokens})
        return logits[:, -1, :]

    return ModelDef(init, apply, name)


def arch_as_model(arch_id: str) -> ModelDef:
    """Wrap a reduced assigned architecture as a next-token classifier
    (predict token at the last position)."""
    cfg = get_config(arch_id).reduced().replace(vocab=256)
    return cfg_as_model(cfg, f"{arch_id}-reduced-lm")


def build_experiment(n_clients: int):
    """The 40,000-token stream (vocab 256, sequences of 32) split 85/15,
    the training part in ``n_clients`` random shards; every client tests
    on the whole held-out part."""
    ds = make_token_lm(40_000, vocab=256, seq_len=32, seed=0)
    n = len(ds)
    cut = int(n * 0.85)
    train = ArrayDataset(ds.x[:cut], ds.y[:cut, -1])
    test = ArrayDataset(ds.x[cut:], ds.y[cut:, -1])

    rng = np.random.default_rng(0)
    order = rng.permutation(cut)
    shards = np.array_split(order, n_clients)
    parts = {f"client_{i}": ArrayDataset(train.x[s], train.y[s])
             for i, s in enumerate(shards)}
    test_parts = {f"client_{i}": test for i in range(n_clients)}
    return parts, test_parts


TASK = TaskConfig(epochs=1, batch_size=16, learning_rate=1e-3,
                  per_sample_time_s=0.02)


def config(rounds: int, stragglers: float, **kw) -> ExperimentConfig:
    return ExperimentConfig(
        strategy="fedlesscan", n_rounds=rounds, clients_per_round=4,
        eval_every=2,
        scenario=ScenarioConfig(straggler_fraction=stragglers,
                                round_timeout_s=60.0), **kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--stragglers", type=float, default=0.25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    parts, test_parts = build_experiment(args.clients)
    model = arch_as_model(args.arch)
    task = ClassificationTask(model, TASK, device=args.device)

    cfg = config(args.rounds, args.stragglers)
    res = run_experiment(task, parts, test_parts, cfg, verbose=True,
                         device=args.device)
    print(f"\nfederated {args.arch}: final top-1 next-token acc "
          f"{res.final_accuracy:.3f}, EUR {res.mean_eur:.2f}, "
          f"cost ${res.total_cost:.4f}")


if __name__ == "__main__":
    main()
