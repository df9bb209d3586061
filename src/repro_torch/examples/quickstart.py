"""Quickstart: train a global model with FedLesScan on simulated FaaS.

Runs a 12-round federated session over 20 clients (30% stragglers) on a
synthetic MNIST-like task and prints the metrics the paper reports:
accuracy, EUR, duration, cost, bias.  The port of the JAX package's
examples/quickstart.py.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

from ..data import label_sorted_shards, make_image_classification
from ..data.synthetic import ArrayDataset
from ..fl.experiment import ExperimentConfig, ScenarioConfig, run_experiment
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models.small import make_cnn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    # --- data: label-sorted non-IID shards (paper's MNIST protocol) ----
    full = make_image_classification(3600, image_size=14, n_classes=5,
                                     seed=0)
    train = ArrayDataset(full.x[:3000], full.y[:3000])
    test = ArrayDataset(full.x[3000:], full.y[3000:])
    parts = label_sorted_shards(train, n_clients=20, shards_per_client=2)
    test_parts = label_sorted_shards(test, n_clients=20,
                                     shards_per_client=2)

    # --- model + task ---------------------------------------------------
    model = make_cnn(image_size=14, channels=1, n_classes=5, fc_width=64)
    task = ClassificationTask(
        model, TaskConfig(epochs=2, batch_size=32, per_sample_time_s=0.05),
        device=args.device)

    # --- run FedLesScan vs FedAvg under 30% stragglers -------------------
    for strategy in ("fedavg", "fedlesscan"):
        cfg = ExperimentConfig(
            strategy=strategy, n_rounds=12, clients_per_round=6,
            eval_every=4,
            scenario=ScenarioConfig(straggler_fraction=0.3,
                                    round_timeout_s=30.0))
        res = run_experiment(task, parts, test_parts, cfg, verbose=True,
                             device=args.device)
        print(f"\n=== {strategy} ===")
        print(f"final accuracy : {res.final_accuracy:.3f}")
        print(f"mean EUR       : {res.mean_eur:.2f}")
        print(f"total duration : {res.total_duration_s:.0f} s (virtual)")
        print(f"total cost     : ${res.total_cost:.4f}")
        print(f"selection bias : {res.bias}\n")


if __name__ == "__main__":
    main()
