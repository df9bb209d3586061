"""The readings that the limits of ``correct`` are set from.

    python3 bench_port/calibrate.py --workload <cell> --seeds <n> ... \
        [--control <k>] [--seconds <s>]

In one process (set-up is long), for each seed: the program's numbers as
a run compares them (its window cut to ``--seconds``, at least the
rounds it checks), the lower readings; then, for the first ``k`` seeds,
the control: the reference put in the program's place and computed in
the configuration's ``control_precision`` (TF32 for the CNN's float32,
float8 e4m3 for the LM's bfloat16 activations; the merge's weighted sum
over rows rounded to TF32), held by
the same numbers against the float32 reference; and for the train cell
the faults of a step (half the batch left out, the state left
unchanged), planted in the reference put in the program's place.  One
JSON line a reading.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def fl_readings(cell, seed: int, device) -> dict:
    """Round 0 from the benchmark's weights, a seeded sample of clients:
    the control (the reference retrained in the control precision) and
    the half-batch fault (each local step's mean over the first half of
    its batch), each against the float32 reference by the cell's client
    numbers (``fl.summarize``: the worst client, and the median client's
    ``grad_gap``); and the merge's control, Eq. 3 over the rows rounded to
    TF32 (10 mantissa bits), the inputs of a TF32 product."""
    import numpy as np
    import torch

    from bench_port.drivers import fl, program
    from bench_port.reference import Quant, control, fp32_exact
    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    from bench_port.traffic import generate

    config, traffic = cell.config, cell.traffic
    program.set_precision(config)
    shards = generate.client_shards(config["model"], traffic, seed)
    g = program.make_weights(config, seed, device)
    rng = np.random.default_rng(seed)
    cids = sorted(shards)
    pick = rng.choice(len(cids), traffic["check"]["clients_per_round_checked"],
                      replace=False)
    loss_fn = program.client_loss(config)

    def half(tree, x, y, model, q=Quant()):
        keep = max(1, x.shape[0] // 2)
        return loss_fn(tree, x[:keep], y[:keep], model, q)

    faults = {"control": (lambda: control(config["control_precision"],
                                          device), loss_fn),
              "half_batch": (lambda: (fp32_exact(), Quant()), half)}
    local = traffic["local"]
    per_client: dict = {name: [] for name in faults}
    rows = []
    for j in pick:
        s = shards[cids[j]]
        x = torch.as_tensor(s.x, device=device)
        y = torch.as_tensor(s.y, device=device)
        cs = ref_train.client_seed(cids[j], 0, traffic["schedule_seed"])
        for name, (make, fn) in faults.items():
            ctx, q = make()
            with ctx:
                got, got_loss = ref_train.local_train(
                    fn, g, x, y, config["model"], local, cs, q)
                first = ref_train.batch_schedule(
                    x.shape[0], local["batch_size"], local["epochs"], cs)[0]
                i = torch.as_tensor(first, device=device)
                live = {k: v.detach().requires_grad_(True) for k, v in
                        ref_weights.leaves(g).items()}
                grads = torch.autograd.grad(
                    fn(ref_train.unflatten_like(live, g), x[i], y[i],
                       config["model"], q), list(live.values()))
                got_grad = {k: float(t.double().norm())
                            for k, t in zip(live, grads)}
            with fp32_exact():
                gaps = fl.client_gaps(config, local, ref_weights.flat(got),
                                      got_loss, got_grad, g, x, y, cs)
            per_client[name].append(gaps)
        with fp32_exact():
            want, _ = ref_train.local_train(loss_fn, g, x, y,
                                            config["model"], local, cs)
        rows.append(ref_weights.flat(want))
    n = [len(shards[cids[j]]) for j in pick]
    want = ref_train.fedlesscan_merge(rows, [0] * len(rows), n, 0,
                                      traffic["tau"])
    c = torch.tensor([k / sum(n) for k in n], device=device)
    got = c @ Quant("tf32")(torch.stack(rows))
    merge_gap = float((got.double() - want).abs().max() / want.abs().max())
    return {name: fl.summarize(gaps, merge_gap if name == "control"
                               else None)
            for name, gaps in per_client.items()}


def train_readings(cell, seed: int, device) -> dict:
    """The control and the faults of a step, each in the reference put
    in the program's place, against the float32 reference."""
    import copy

    from bench_port.drivers import train as tr
    losses, grad1, change = tr.reference_steps(cell, seed, device)
    out = {}
    ctl = tr.reference_steps(cell, seed, device,
                             cell.config["control_precision"])
    out["control"] = tr.numbers_of(*ctl, losses, grad1, change)
    half = copy.deepcopy(cell)
    half.traffic["batch"] //= 2
    h = tr.reference_steps(half, seed, device)
    # the half batch's rows are the first half of each full batch only
    # for step 0; later steps read other rows: a fault all the same
    out["half_batch"] = tr.numbers_of(*h, losses, grad1, change)
    zero = {k: 0.0 for k in change}
    out["unchanged"] = tr.numbers_of(losses, grad1, zero, losses, grad1,
                                     change)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import gc

    import torch

    from bench_port import harness
    cell = harness.load_cell(args.workload)
    kind = cell.traffic["kind"]
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        rec = harness.driver(kind).run(cell, seed, args.seconds, False,
                                       device="cuda")
        print(json.dumps({"seed": seed, "reading": "program",
                          "numbers": {k: c["value"] for k, c in
                                      rec.checks.items()},
                          "look": rec.notes.get("look"),
                          "units": rec.units,
                          "s": time.perf_counter() - t}), flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        if i < args.control:
            t = time.perf_counter()
            if kind == "fl":
                got = fl_readings(cell, seed, "cuda")
            else:
                got = train_readings(cell, seed, "cuda")
            for name, numbers in got.items():
                print(json.dumps({"seed": seed, "reading": name,
                                  "numbers": numbers,
                                  "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
