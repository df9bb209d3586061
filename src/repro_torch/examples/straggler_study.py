"""Straggler study: sweep straggler ratios across all three strategies —
the end-to-end driver reproducing the shape of paper Tables II–IV on the
Google-Speech-like task.  The port of the JAX package's
examples/straggler_study.py.

    PYTHONPATH=src python -m repro_torch.examples.straggler_study \
        [--ratios 0,0.3,0.5] [--device cpu]
"""
import argparse

from ..data import label_sorted_shards, make_speech_commands
from ..data.synthetic import ArrayDataset
from ..fl.experiment import ExperimentConfig, ScenarioConfig, run_experiment
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models.small import make_speech_cnn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ratios", default="0,0.3,0.5")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    ratios = [float(r) for r in args.ratios.split(",")]

    full = make_speech_commands(3000, frames=16, mels=16, n_classes=8,
                                seed=0)
    train = ArrayDataset(full.x[:2500], full.y[:2500])
    test = ArrayDataset(full.x[2500:], full.y[2500:])
    parts = label_sorted_shards(train, args.clients, 2)
    test_parts = label_sorted_shards(test, args.clients, 2)
    task = ClassificationTask(
        make_speech_cnn(16, 16, 8),
        TaskConfig(epochs=2, batch_size=16, per_sample_time_s=0.04),
        device=args.device)

    print(f"{'strategy':12s} {'strag%':>6s} {'acc':>6s} {'EUR':>5s} "
          f"{'time(s)':>8s} {'cost($)':>8s} {'bias':>4s}")
    for ratio in ratios:
        for strategy in ("fedavg", "fedprox", "fedlesscan"):
            cfg = ExperimentConfig(
                strategy=strategy, n_rounds=args.rounds,
                clients_per_round=6, eval_every=0,
                scenario=ScenarioConfig(straggler_fraction=ratio,
                                        round_timeout_s=30.0))
            res = run_experiment(task, parts, test_parts, cfg,
                                 device=args.device)
            print(f"{strategy:12s} {int(ratio*100):5d}% "
                  f"{res.final_accuracy:6.3f} {res.mean_eur:5.2f} "
                  f"{res.total_duration_s:8.0f} {res.total_cost:8.4f} "
                  f"{res.bias:4d}")


if __name__ == "__main__":
    main()
