"""FL training driver — the paper's controller as a CLI, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train \
      --dataset femnist --strategy fedlesscan --rounds 20 \
      --clients 30 --clients-per-round 8 --stragglers 0.3

Datasets are the synthetic analogues of the paper's four (see
data/synthetic.py), each with its model and Table I hyperparameters:
``mnist`` and ``femnist`` (the LEAF CNN, local Adam), ``shakespeare``
(the char-LSTM, local SGD at lr 0.8, batch 32, 1 epoch) and ``speech``
(the speech CNN, local Adam, batch 5, 5 epochs).  ``--device`` defaults
to ``cuda``; ``--server-opt`` picks the server optimizer of the merge
(``sgd`` is the identity merge).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..core.merge import SERVER_OPTS
from ..data import (label_sorted_shards, make_char_lm,
                    make_image_classification, make_speech_commands)
from ..data.synthetic import ArrayDataset
from ..device import DeviceLike
from ..fl.experiment import (ExperimentConfig, ScenarioConfig,
                             run_experiment)
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models.small import make_char_lstm, make_cnn, make_speech_cnn

DATASETS = ("mnist", "femnist", "shakespeare", "speech")
# the adaptive server optimizers take a small server rate (Reddi et al.,
# arXiv:2003.00295, tune it in 1e-3..1e-1); sgd/fedavgm keep 1.0
SERVER_LR = {"fedadagrad": 0.01, "fedadam": 0.01, "fedyogi": 0.01}


def build_dataset(name: str, n_clients: int, seed: int = 0,
                  device: DeviceLike = None):
    """Returns (task, train_partitions, test_partitions) mirroring the
    paper's per-dataset hyperparameters (Table I); the task runs on
    ``device`` (``None`` means ``"cuda"``)."""
    if name == "mnist":
        full = make_image_classification(n_clients * 220, 28, 10, seed=seed)
        model = make_cnn(28, 1, 10, 512, "mnist_cnn")
        tcfg = TaskConfig(epochs=5, batch_size=10, learning_rate=1e-3,
                          per_sample_time_s=0.02)
    elif name == "femnist":
        full = make_image_classification(n_clients * 240, 28, 62, seed=seed)
        model = make_cnn(28, 1, 62, 2048, "femnist_cnn")
        tcfg = TaskConfig(epochs=5, batch_size=10, learning_rate=1e-3,
                          per_sample_time_s=0.03)
    elif name == "shakespeare":
        full = make_char_lm(n_clients * 160, seq_len=80, vocab=82, seed=seed)
        model = make_char_lstm(82, 8, 256)
        tcfg = TaskConfig(epochs=1, batch_size=32, learning_rate=0.8,
                          optimizer="sgd", per_sample_time_s=0.05)
    elif name == "speech":
        full = make_speech_commands(n_clients * 200, 32, 32, 35, seed=seed)
        model = make_speech_cnn(32, 32, 35)
        tcfg = TaskConfig(epochs=5, batch_size=5, learning_rate=1e-3,
                          per_sample_time_s=0.02)
    else:
        raise ValueError(f"unknown dataset {name!r}")

    n = len(full)
    cut = int(n * 0.85)
    train = ArrayDataset(full.x[:cut], full.y[:cut])
    test = ArrayDataset(full.x[cut:], full.y[cut:])
    parts = label_sorted_shards(train, n_clients, 2, seed=seed)
    test_parts = label_sorted_shards(test, n_clients, 2, seed=seed)
    return ClassificationTask(model, tcfg, device=device), parts, test_parts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist", choices=DATASETS)
    ap.add_argument("--strategy", default="fedlesscan",
                    choices=["fedavg", "fedprox", "fedlesscan"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--clients-per-round", type=int, default=8)
    ap.add_argument("--stragglers", type=float, default=0.0,
                    help="straggler fraction (0 = standard scenario)")
    ap.add_argument("--round-timeout", type=float, default=120.0)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--server-opt", default="sgd", choices=SERVER_OPTS,
                    help="server optimizer of the merge (sgd = identity)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()

    task, parts, test_parts = build_dataset(args.dataset, args.clients,
                                            args.seed, device=args.device)
    cfg = ExperimentConfig(
        strategy=args.strategy, n_rounds=args.rounds,
        clients_per_round=args.clients_per_round, tau=args.tau,
        seed=args.seed, eval_every=5,
        server_opt=args.server_opt,
        server_opt_lr=SERVER_LR.get(args.server_opt, 1.0),
        scenario=ScenarioConfig(straggler_fraction=args.stragglers,
                                round_timeout_s=args.round_timeout,
                                seed=args.seed))
    res = run_experiment(task, parts, test_parts, cfg, verbose=args.verbose,
                         device=args.device)

    summary = {
        "dataset": args.dataset, "strategy": args.strategy,
        "server_opt": args.server_opt, "device": str(task.device),
        "rounds": args.rounds, "stragglers": args.stragglers,
        "final_accuracy": res.final_accuracy,
        "mean_eur": res.mean_eur,
        "total_duration_s": res.total_duration_s,
        "total_cost_usd": res.total_cost,
        "bias": res.bias,
        "accuracy_curve": res.accuracy_curve,
    }
    print(json.dumps(summary, indent=2))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
