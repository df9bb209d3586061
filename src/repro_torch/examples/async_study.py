"""Async study: sync vs semi-async vs barrier-free training modes under
straggler injection, on identical seeds, task, and straggler profile.

Four strategies ride the same mode-agnostic TrainingDriver:

    fedavg      sync        round barrier, late updates discarded
    fedlesscan  semi-async  round barrier + staleness-damped late merges
    fedasync    async       barrier-free, merge-per-arrival (Xie et al.)
    fedbuff     async       barrier-free, buffer-K merges (Nguyen et al.)

Each run exports its JSONL trace (one record per invocation attempt,
billing charge, and aggregation event) to results/async_study/, and the
first async strategy is run twice to demonstrate byte-identical traces —
virtual-clock determinism survives the barrier-free mode.

``--server-opt`` adds a sweep column: every strategy is additionally run
with each named server optimizer on the merge pipeline (core/merge.py),
so the table shows e.g. how FedAdam/FedYogi server updates interact with
staleness-damped async pseudo-gradients.

``--compression`` adds compressed-update rows (core/compress.py): every
strategy is additionally run with each named codec on the client→server
wire, and the table gains Δcost($)/ΔEUR columns against that strategy's
plaintext run. Plaintext runs model the upload as free; compressed runs
bill real egress bytes and transfer time, so Δcost($) is the wire cost
the run now accounts for — tighter codecs (top-k) add less than looser
ones (int8) — while ΔEUR shows whether the codec hurt update delivery.

The port of the JAX package's examples/async_study.py.

    PYTHONPATH=src python -m repro_torch.examples.async_study \
        [--ratio 0.3 --rounds 8] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.async_study \
        --server-opt fedadam --server-opt fedyogi
    PYTHONPATH=src python -m repro_torch.examples.async_study \
        --compression topk --compression int8
"""
import argparse
from pathlib import Path

from ..data import label_sorted_shards, make_image_classification
from ..data.synthetic import ArrayDataset
from ..device import DeviceLike
from ..fl.experiment import ExperimentConfig, ScenarioConfig, run_experiment
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models.small import make_cnn
from . import RESULTS

STRATEGIES = ("fedavg", "fedlesscan", "fedasync", "fedbuff")
OUT = RESULTS / "async_study"


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


# adaptive server optimizers take a smaller step than the identity
SERVER_OPT_LR = {"sgd": 1.0, "fedavgm": 0.9, "fedadagrad": 0.1,
                 "fedadam": 0.1, "fedyogi": 0.1}


def run_one(strategy: str, task, parts, test_parts, args,
            trace_path: Path, server_opt: str = "sgd",
            compress: str = "none"):
    cfg = ExperimentConfig(
        strategy=strategy, n_rounds=args.rounds,
        clients_per_round=args.cohort, eval_every=0, seed=args.seed,
        buffer_k=args.buffer_k, trace_path=str(trace_path),
        server_opt=server_opt,
        server_opt_lr=SERVER_OPT_LR.get(server_opt, 0.1),
        compress_scheme=compress,
        scenario=ScenarioConfig(straggler_fraction=args.ratio,
                                round_timeout_s=30.0, seed=args.seed))
    return run_experiment(task, parts, test_parts, cfg, device=args.device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ratio", type=float, default=0.3)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=24)
    ap.add_argument("--cohort", type=int, default=6)
    ap.add_argument("--buffer-k", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--server-opt", action="append", default=None,
                    metavar="NAME", dest="server_opts",
                    help="additional merge-pipeline server optimizers to "
                         "sweep (repeatable; 'sgd' — the identity — "
                         "always runs first)")
    ap.add_argument("--compression", action="append", default=None,
                    metavar="SCHEME", dest="compressions",
                    help="update codecs to sweep (repeatable; 'topk' or "
                         "'int8') — each adds a row per strategy with "
                         "Δcost($)/ΔEUR against the plaintext run")
    ap.add_argument("--skip-determinism-check", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    server_opts = ["sgd"] + [o for o in (args.server_opts or [])
                             if o != "sgd"]
    compressions = [c for c in (args.compressions or []) if c != "none"]

    task, parts, test_parts = build_task(args.clients, seed=args.seed,
                                         device=args.device)
    print(f"straggler ratio {int(args.ratio * 100)}%, "
          f"{args.rounds} rounds x cohort {args.cohort}\n")
    print(f"{'strategy':12s} {'srv-opt':10s} {'compress':9s} {'mode':10s} "
          f"{'acc':>6s} {'EUR':>5s} {'aggs':>5s} {'time(s)':>8s} "
          f"{'cost($)':>8s} {'Δcost($)':>9s} {'ΔEUR':>6s}")

    def show(strategy, server_opt, compress, res, base=None):
        delta = ("" if base is None else
                 f"{res.total_cost - base.total_cost:+9.4f} "
                 f"{res.mean_eur - base.mean_eur:+6.2f}")
        print(f"{strategy:12s} {server_opt:10s} {compress:9s} "
              f"{res.mode:10s} {res.final_accuracy:6.3f} "
              f"{res.mean_eur:5.2f} {len(res.rounds):5d} "
              f"{res.total_duration_s:8.0f} {res.total_cost:8.4f} {delta}")

    results = {}
    for strategy in STRATEGIES:
        for server_opt in server_opts:
            suffix = "" if server_opt == "sgd" else f"_{server_opt}"
            trace = OUT / f"{strategy}{suffix}.jsonl"
            res = run_one(strategy, task, parts, test_parts, args, trace,
                          server_opt=server_opt)
            results.setdefault(strategy, res)     # sgd row anchors checks
            show(strategy, server_opt, "-", res)
        for scheme in compressions:
            trace = OUT / f"{strategy}_{scheme}.jsonl"
            res = run_one(strategy, task, parts, test_parts, args, trace,
                          compress=scheme)
            show(strategy, "sgd", scheme, res, base=results[strategy])

    semi = results["fedlesscan"].mean_eur
    for name in ("fedasync", "fedbuff"):
        ok = results[name].mean_eur >= semi
        print(f"\n{name} EUR {results[name].mean_eur:.2f} "
              f"{'>=' if ok else '<'} semi-async EUR {semi:.2f} "
              f"({'ok' if ok else 'REGRESSION'})")

    if not args.skip_determinism_check:
        trace = OUT / "fedbuff.jsonl"
        again = OUT / "fedbuff_rerun.jsonl"
        run_one("fedbuff", task, parts, test_parts, args, again)
        identical = trace.read_bytes() == again.read_bytes()
        print(f"\ndeterminism: rerun trace byte-identical = {identical}")
        if not identical:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
