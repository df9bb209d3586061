"""Scheduler study: four cohort policies under 30% stragglers, on
identical seeds, task, straggler profile, and (semi-async FedLesScan)
aggregation — only the `Scheduler` (fl/scheduler.py) varies:

    random      uniform sampling (FedAvg-style, straggler-blind)
    fedlesscan  Algorithm 2 tier selection (DBSCAN behaviour clusters)
    apodotiko   score-based softmax sampling (duration EMA, success
                rate, cold-start rate, staleness; annealed temperature)
    adaptive    trailing-EUR cohort sizing over random selection

Reported per policy: final accuracy, mean EUR, time-to-accuracy (first
virtual second the evaluated accuracy reaches --target), and total cost
from the CostMeter.  Acceptance: apodotiko's EUR must match or beat the
fedlesscan scheduler's on the same seeds (exit 1 otherwise).  Each run's
trace goes to results/scheduler_study/<scheduler>.jsonl.  The port of the
JAX package's examples/scheduler_study.py.

    PYTHONPATH=src python -m repro_torch.examples.scheduler_study \
        [--ratio 0.3] [--device cpu]
"""
import argparse

from ..data import label_sorted_shards, make_image_classification
from ..data.synthetic import ArrayDataset
from ..device import DeviceLike
from ..fl.experiment import ExperimentConfig, ScenarioConfig, run_experiment
from ..fl.metrics import time_to_accuracy
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models.small import make_cnn
from . import RESULTS

SCHEDULERS = ("random", "fedlesscan", "apodotiko", "adaptive")
OUT = RESULTS / "scheduler_study"


def build_task(n_clients: int, seed: int = 0, device: DeviceLike = None):
    full = make_image_classification(1300, image_size=14, n_classes=5,
                                     seed=seed)
    train = ArrayDataset(full.x[:1100], full.y[:1100])
    test = ArrayDataset(full.x[1100:], full.y[1100:])
    parts = label_sorted_shards(train, n_clients, 2, seed=seed)
    test_parts = label_sorted_shards(test, n_clients, 2, seed=seed)
    task = ClassificationTask(
        make_cnn(14, 1, 5, 32),
        TaskConfig(epochs=1, batch_size=32, per_sample_time_s=0.05),
        device=device)
    return task, parts, test_parts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ratio", type=float, default=0.3)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--cohort", type=int, default=6)
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--target", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    task, parts, test_parts = build_task(args.clients, seed=args.seed,
                                         device=args.device)
    print(f"straggler ratio {int(args.ratio * 100)}%, {args.rounds} rounds "
          f"x cohort {args.cohort}, semi-async fedlesscan aggregation\n")
    print(f"{'scheduler':12s} {'acc':>6s} {'EUR':>5s} "
          f"{'t@{:.0%}'.format(args.target):>8s} {'time(s)':>8s} "
          f"{'cost($)':>8s}")

    results = {}
    for scheduler in SCHEDULERS:
        cfg = ExperimentConfig(
            strategy="fedlesscan", scheduler=scheduler,
            n_rounds=args.rounds, clients_per_round=args.cohort,
            eval_every=args.eval_every, seed=args.seed,
            trace_path=str(OUT / f"{scheduler}.jsonl"),
            scenario=ScenarioConfig(straggler_fraction=args.ratio,
                                    round_timeout_s=30.0, seed=args.seed))
        res = run_experiment(task, parts, test_parts, cfg,
                             device=args.device)
        results[scheduler] = res
        tta = time_to_accuracy(res.accuracy_curve,
                               [r.duration_s for r in res.rounds],
                               args.target)
        tta_s = f"{tta:8.0f}" if tta != float("inf") else "     inf"
        print(f"{scheduler:12s} {res.final_accuracy:6.3f} "
              f"{res.mean_eur:5.2f} {tta_s} {res.total_duration_s:8.0f} "
              f"{res.total_cost:8.4f}")

    apo = results["apodotiko"].mean_eur
    fls = results["fedlesscan"].mean_eur
    ok = apo >= fls
    print(f"\napodotiko EUR {apo:.2f} {'>=' if ok else '<'} "
          f"fedlesscan EUR {fls:.2f} ({'ok' if ok else 'REGRESSION'})")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
