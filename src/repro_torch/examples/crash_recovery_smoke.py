"""Crash-recovery smoke test: SIGKILL a training run mid-round, resume
from its last checkpoint, and assert the recovered run reproduces an
uninterrupted same-seed run exactly.

Exercises the full-fidelity checkpoint path end-to-end across *process*
boundaries (the checkpoint is written by a child process that is killed
without warning, the resume happens in the parent):

    1. run a clean same-seed reference in-process → metrics + trace;
    2. spawn the same experiment as a subprocess with checkpointing on,
       wait until a checkpoint pair lands on disk, SIGKILL the child;
    3. resume from the last checkpoint in-process and compare the final
       metrics (and the replayed rounds) with the clean reference.

The port of the JAX package's examples/crash_recovery_smoke.py; the
child is this module again (``python -m``), on the parent's device.

    PYTHONPATH=src python -m repro_torch.examples.crash_recovery_smoke \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.crash_recovery_smoke \
        --child out/
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from ..data import label_sorted_shards, make_image_classification
from ..data.synthetic import ArrayDataset
from ..device import DeviceLike
from ..fl.experiment import ExperimentConfig, ScenarioConfig, run_experiment
from ..fl.tasks import ClassificationTask, TaskConfig
from ..models.small import make_cnn
from . import REPO, RESULTS

N_ROUNDS = 12
CHECKPOINT_EVERY = 2
OUT = RESULTS / "crash_recovery"


def build_experiment(device: DeviceLike = None):
    full = make_image_classification(320, image_size=14, n_classes=3, seed=0)
    train = ArrayDataset(full.x[:240], full.y[:240])
    test = ArrayDataset(full.x[240:], full.y[240:])
    parts = label_sorted_shards(train, 6, 2, seed=0)
    test_parts = label_sorted_shards(test, 6, 2, seed=0)
    task = ClassificationTask(
        make_cnn(14, 1, 3, 8),
        TaskConfig(epochs=1, batch_size=32, per_sample_time_s=0.05),
        device=device)
    return task, parts, test_parts


def config(**kw) -> ExperimentConfig:
    return ExperimentConfig(
        strategy="fedlesscan", n_rounds=N_ROUNDS, clients_per_round=4,
        eval_every=0, seed=0,
        scenario=ScenarioConfig(straggler_fraction=0.3, slow_factor=6.0,
                                round_timeout_s=60.0, seed=0), **kw)


def run_child(workdir: Path, device: DeviceLike = None) -> None:
    """Subprocess body: train with checkpointing until SIGKILLed."""
    task, parts, test_parts = build_experiment(device)
    run_experiment(task, parts, test_parts,
                   config(checkpoint_dir=str(workdir / "ck"),
                          checkpoint_every=CHECKPOINT_EVERY), device=device)
    # reaching this line just means the kill raced past the run's end;
    # the parent still resumes from the last checkpoint on disk


def wait_for_checkpoint(ckdir: Path, proc, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        pairs = {p.stem for p in ckdir.glob("round_*.json")} \
            & {p.stem for p in ckdir.glob("round_*.npz")}
        if pairs:
            return
        if proc.poll() is not None:
            return                      # child finished before the kill
        time.sleep(0.2)
    raise RuntimeError(f"no checkpoint appeared in {ckdir} "
                       f"within {timeout_s}s")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=str(OUT))
    ap.add_argument("--child", metavar="WORKDIR",
                    help="internal: run the killable training subprocess")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.child:
        run_child(Path(args.child), args.device)
        return 0

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    task, parts, test_parts = build_experiment(args.device)

    print("[1/3] clean same-seed reference run")
    clean = run_experiment(
        task, parts, test_parts,
        config(trace_path=str(workdir / "clean_trace.jsonl")),
        device=args.device)

    print("[2/3] child run with checkpointing — SIGKILL mid-round")
    env = dict(os.environ)
    src = str(REPO / "src")
    env["PYTHONPATH"] = (src + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else src)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.crash_recovery_smoke",
         "--child", str(workdir), "--device", args.device], env=env)
    wait_for_checkpoint(workdir / "ck", proc)
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait()
    print(f"    child exited with {proc.returncode} "
          f"(negative = killed by signal)")

    print("[3/3] resume from the last checkpoint and compare")
    resumed = run_experiment(
        task, parts, test_parts,
        config(resume_from=str(workdir / "ck"),
               trace_path=str(workdir / "resumed_trace.jsonl")),
        device=args.device)

    failures = []
    if resumed.final_accuracy != clean.final_accuracy:
        failures.append(f"final_accuracy {resumed.final_accuracy!r} != "
                        f"clean {clean.final_accuracy!r}")
    clean_by_round = {r.round_number: r for r in clean.rounds}
    for r in resumed.rounds:
        want = clean_by_round.get(r.round_number)
        if want is None:
            failures.append(f"resumed produced unknown round "
                            f"{r.round_number}")
            continue
        for attr in ("selected", "successes", "late", "crashed",
                     "duration_s", "cost"):
            if getattr(r, attr) != getattr(want, attr):
                failures.append(
                    f"round {r.round_number} {attr}: "
                    f"{getattr(r, attr)!r} != {getattr(want, attr)!r}")
    report = {
        "clean_final_accuracy": clean.final_accuracy,
        "resumed_final_accuracy": resumed.final_accuracy,
        "resumed_rounds": [r.round_number for r in resumed.rounds],
        "failures": failures,
    }
    (workdir / "report.json").write_text(json.dumps(report, indent=2))
    if failures:
        print("FAIL: recovered run diverged from the clean run:")
        for f in failures:
            print("  -", f)
        return 1
    print(f"OK: resumed rounds {report['resumed_rounds']} replay the "
          f"clean run exactly (final acc {clean.final_accuracy:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
