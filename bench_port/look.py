"""The look behind the FL check's readings, for a CNN cell: every client
that a run checks, held against the float32 reference and against a
second witness, the same reference in float64.

    python3 bench_port/look.py --workload <cell> --seeds <n> ... \
        [--trace-seeds <n> ...] [--seconds <s>]

For each seed: one run of the cell (its result's numbers, its rounds'
times and its peak on a ``run`` line), then a ``client`` line for each
checked client with the gaps of the three pairs (program and float32
reference, program and float64 reference, the two references), by the
numbers of ``fl.gaps_between``, and, for the first local step's batch,
the ReLU inputs nearest their kink in float64 (over each layer's RMS) and
how many ReLU gates the two references set apart.  Where the program's
first-step gradient norms part from both references by more than
``FLAGGED``, each ReLU gate within ``NEAR`` of its kink is flipped in
the float64 reference in turn and the gap to the program read again.
With ``--ensemble n``, a client whose mean loss
parts from the reference's by ``PARTED`` (and, for comparison, a run's
first three clients) is retrained ``n`` times by the float32 reference
from params moved by about float32's rounding (``ensemble``).  The
benchmark's own runs never run this.
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

FLAGGED = 1e-4     # a first-step gradient gap this large is looked into
NEAR = 1e-5        # a ReLU input within this share of its layer's RMS
PARTED = 0.01      # a mean-loss gap this large is looked into
ULP = 2.0 ** -23   # float32's relative spacing
LAYERS = ("conv1", "conv2", "fc1")


def cnn_gated(params: dict, x, flip=None):
    """The reference CNN's forward (``reference.models.cnn_forward``) with
    each ReLU written as pre·gate, gate = pre > 0, and the gate ``flip``
    = (layer, flat index) inverted: (logits, the ReLU inputs)."""
    import torch.nn.functional as F
    pres = []

    def relu(pre, layer):
        gate = (pre > 0).to(pre.dtype)
        if flip is not None and flip[0] == layer:
            gate = gate.reshape(-1).clone()
            gate[flip[1]] = 1 - gate[flip[1]]
            gate = gate.reshape(pre.shape)
        pres.append(pre.detach())
        return pre * gate

    h = x.permute(0, 3, 1, 2)
    for i, name in enumerate(("conv1", "conv2")):
        w = params[name]["w"].permute(3, 2, 0, 1)
        h = F.conv2d(h, w, params[name]["b"],
                     padding=(w.shape[2] // 2, w.shape[3] // 2))
        h = F.max_pool2d(relu(h, i), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = relu(h @ params["fc1"]["w"] + params["fc1"]["b"], 2)
    return h @ params["out"]["w"] + params["out"]["b"], pres


def first_step(g: dict, x, y, flip=None):
    """Per-leaf gradient norms of the first batch's loss and the ReLU
    inputs, by ``cnn_gated``."""
    import torch
    import torch.nn.functional as F

    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    live = {k: v.detach().requires_grad_(True) for k, v in
            ref_weights.leaves(g).items()}
    logits, pres = cnn_gated(ref_train.unflatten_like(live, g), x, flip)
    grads = torch.autograd.grad(F.cross_entropy(logits, y.long()),
                                list(live.values()))
    return {k: float(t.double().norm()) for k, t in zip(live, grads)}, pres


def look_client(cell, g32: dict, c: dict, shard, rnd: int, device) -> dict:
    import torch

    from bench_port.drivers import fl
    from bench_port.reference import fp32_exact
    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    config, traffic = cell.config, cell.traffic
    local = traffic["local"]
    cs = ref_train.client_seed(c["cid"], rnd, traffic["schedule_seed"])
    g64 = ref_train.unflatten_like(
        {k: v.double() for k, v in ref_weights.leaves(g32).items()}, g32)
    x32 = torch.as_tensor(shard.x, device=device)
    y = torch.as_tensor(shard.y, device=device)
    x64 = x32.double()
    prog = (c["row"].to(device), c["loss"], c["grad"])
    with fp32_exact():
        r32 = fl.reference_client(config, local, g32, x32, y, cs)
        r64 = fl.reference_client(config, local, g64, x64, y, cs)
        pairs = {"prog~ref32": fl.gaps_between(prog, r32, g32),
                 "prog~ref64": fl.gaps_between(prog, r64, g32),
                 "ref32~ref64": fl.gaps_between(r32, r64, g32)}
        first = ref_train.batch_schedule(x32.shape[0], local["batch_size"],
                                         local["epochs"], cs)[0]
        i = torch.as_tensor(first, device=device)
        _, pres32 = first_step(g32, x32[i], y[i])
        _, pres64 = first_step(g64, x64[i], y[i])
    keys = ("grad_gap", "grad_gap_median", "change_gap", "change_gap_median",
            "update_gap", "loss_gap")
    out = {"round": rnd, "cid": c["cid"],
           **{f"{pair}.{k}": gaps[k] for pair, gaps in pairs.items()
              for k in keys}}
    margins, near = {}, []
    for layer, p32, p64 in zip(LAYERS, pres32, pres64):
        rms = float(p64.pow(2).mean().sqrt())
        rel = (p64.abs() / rms).reshape(-1)
        margins[layer] = {"min_rel": float(rel.min()),
                          "gates_apart": int(((p32 > 0) != (p64 > 0)).sum()),
                          "near": int((rel < NEAR).sum())}
        near += [(LAYERS.index(layer), int(j), float(rel[j]))
                 for j in torch.nonzero(rel < NEAR).reshape(-1).tolist()]
    out["relu"] = margins
    if min(pairs["prog~ref32"]["grad_gap"],
           pairs["prog~ref64"]["grad_gap"]) > FLAGGED:
        out["grad_gap_by_leaf"] = {k: v for k, v in
                                   pairs["prog~ref64"].items()
                                   if k.startswith("grad_gap.")}
        flips = []
        for layer, j, rel in near[:32]:
            got, _ = first_step(g64, x64[i], y[i], flip=(layer, j))
            flips.append({"layer": LAYERS[layer], "index": j, "rel": rel,
                          "prog~flipped64": fl.worst_leaf(c["grad"], got)})
        out["flips"] = flips
    return out


def ensemble(cell, g32: dict, c: dict, shard, rnd: int, device, n: int
             ) -> list:
    """The float32 reference retrained ``n`` times from the round's
    global params, each element moved by ULP·N(0, 1) of itself (about
    the rounding that sets two float32 programs apart): each retrained
    client against the unmoved reference, and the program against it."""
    import torch

    from bench_port.drivers import fl
    from bench_port.reference import fp32_exact
    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    config, traffic = cell.config, cell.traffic
    local = traffic["local"]
    cs = ref_train.client_seed(c["cid"], rnd, traffic["schedule_seed"])
    x = torch.as_tensor(shard.x, device=device)
    y = torch.as_tensor(shard.y, device=device)
    gen = torch.Generator(device=device).manual_seed(cs)
    keys = ("change_gap", "change_gap_median", "update_gap", "loss_gap")
    prog = (c["row"].to(device), c["loss"], c["grad"])
    out = []
    with fp32_exact():
        ref = fl.reference_client(config, local, g32, x, y, cs)
        for _ in range(n):
            moved = ref_train.unflatten_like(
                {k: v * (1 + ULP * torch.randn(v.shape, generator=gen,
                                               device=device))
                 for k, v in ref_weights.leaves(g32).items()}, g32)
            got = fl.reference_client(config, local, moved, x, y, cs)
            a = fl.gaps_between(got, ref, g32)
            b = fl.gaps_between(prog, got, g32)
            out.append({**{f"moved~ref32.{k}": a[k] for k in keys},
                        **{f"prog~moved.{k}": b[k] for k in keys}})
    return out


def noisy_train(config: dict, local: dict, g: dict, x, y, seed: int,
                rel: float, gen, add: bool = False):
    """``reference.train.local_train`` with each gradient element scaled
    by 1 + rel·N(0, 1) at every step, or with ``add`` moved by rel·N(0, 1)
    times its leaf's RMS (which can turn the sign of an element near
    zero): (row, mean loss, largest step loss)."""
    import numpy as np
    import torch

    from bench_port.drivers import fl, program
    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    loss_fn = program.client_loss(config)
    params = {k: v.detach().clone() for k, v in
              ref_weights.leaves(g).items()}
    opt = ref_train.Adam(local["learning_rate"])
    state = opt.init(params)
    losses = []
    for idx in ref_train.batch_schedule(x.shape[0], local["batch_size"],
                                        local["epochs"], seed):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        i = torch.as_tensor(idx, device=x.device)
        loss = loss_fn(ref_train.unflatten_like(live, g), x[i], y[i],
                       config["model"])
        grads = torch.autograd.grad(loss, list(live.values()))
        grads = [t + rel * t.pow(2).mean().sqrt() * torch.randn(
                     t.shape, generator=gen, device=t.device) if add else
                 t * (1 + rel * torch.randn(t.shape, generator=gen,
                                            device=t.device))
                 for t in grads]
        with torch.no_grad():
            params = opt.step({k: v.detach() for k, v in live.items()},
                              dict(zip(live, grads)), state)
        losses.append(float(loss.detach()))
    row = fl.flat64(ref_train.unflatten_like(params, g))
    return row, float(np.mean(losses)), max(losses)


def replay(cell, driver, cap: dict, g32: dict, c: dict, shards, rnd: int,
           device, n: int) -> dict:
    """The client's training again: by the program's executor on the
    round's own group and on the client alone (each against the captured
    answer and the float32 reference), and by ``n`` float32 references
    with noise on every gradient element (``noisy_train``: scaled by
    1e-5, moved by 1e-6 and 1e-5 of the leaf's RMS), each against the
    reference without noise."""
    import torch

    from bench_port.drivers import fl
    from bench_port.reference import fp32_exact
    from bench_port.reference import train as ref_train
    config, traffic = cell.config, cell.traffic
    local = traffic["local"]
    pool, ex = driver.pool, driver.pool.executor
    cid = c["cid"]
    cs = ref_train.client_seed(cid, rnd, traffic["schedule_seed"])
    x = torch.as_tensor(shards[cid].x, device=device)
    y = torch.as_tensor(shards[cid].y, device=device)
    keys = ("change_gap", "change_gap_median", "update_gap", "loss_gap")
    captured = (c["row"].to(device), c["loss"], c["grad"])
    out = {}
    with fp32_exact():
        ref = fl.reference_client(config, local, g32, x, y, cs)
        group = next(gr for gr in cap["groups"] if cid in gr)
        for name, cids in (("group", group), ("alone", [cid])):
            batch = ex.run_group_batch(
                cids, [pool.clients[k].dataset for k in cids], g32,
                pool.proximal_mu, [pool.client_seed(k, rnd) for k in cids])
            i = cids.index(cid)
            got = (batch.row(i), float(batch._losses[i]), c["grad"])
            a = fl.gaps_between(got, captured, g32)
            b = fl.gaps_between(got, ref, g32)
            out[name] = {**{f"~captured.{k}": a[k] for k in keys},
                         **{f"~ref32.{k}": b[k] for k in keys}}
            del batch
        gen = torch.Generator(device=device).manual_seed(cs)
        for add, rel in ((False, 1e-5), (True, 1e-6), (True, 1e-5)):
            runs = []
            for _ in range(n):
                row, loss, top = noisy_train(config, local, g32, x, y, cs,
                                             rel, gen, add)
                a = fl.gaps_between((row, loss, ref[2]), ref, g32)
                runs.append({**{k: a[k] for k in keys}, "top_loss": top})
            out[f"{'add' if add else 'scale'}{rel:g}"] = runs
    return out


def lockstep(cell, driver, cap: dict, g32: dict, cid: str, shards,
             rnd: int, device, steps: int = 1) -> dict:
    """The program's executor loop for the round's group, step by step
    (``VectorizedExecutor._train_slices`` on one slice, its own step,
    optimizer and inputs), beside the float32 reference on the client's
    batches: at every ``steps``-th step the client's program loss, the
    reference's, and ‖p − r‖ / ‖r − g‖; at the end the replica's row
    against the captured one."""
    import torch

    from bench_port.drivers import fl, program
    from bench_port.reference import fp32_exact
    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    from repro_torch.fl import executor as exm
    config, traffic = cell.config, cell.traffic
    local = traffic["local"]
    pool, ex = driver.pool, driver.pool.executor
    group = next(gr for gr in cap["groups"] if cid in gr)
    row = group.index(cid)
    xs, ys, ms = ex._stage([pool.clients[k].dataset for k in group],
                           [pool.client_seed(k, rnd) for k in group],
                           exm._bucket(len(group)))
    xs, ys, ms = (torch.from_numpy(a).to(device) for a in (xs, ys, ms))
    opt = ex.task.optimizer
    step = exm.vmap(exm.grad_and_value(ex._masked_loss))
    k = xs.shape[0]
    params = exm.tree_map(
        lambda v: v.unsqueeze(0).expand(k, *v.shape).clone(), g32)
    state = opt.init(params)
    loss_fn = program.client_loss(config)
    cs = ref_train.client_seed(cid, rnd, traffic["schedule_seed"])
    x = torch.as_tensor(shards[cid].x, device=device)
    y = torch.as_tensor(shards[cid].y, device=device)
    ref = {k_: v.detach().clone() for k_, v in
           ref_weights.leaves(g32).items()}
    adam = ref_train.Adam(local["learning_rate"])
    rstate = adam.init(ref)
    g_flat = fl.flat64(g32)
    trace = []
    with fp32_exact():
        for t, idx in enumerate(ref_train.batch_schedule(
                x.shape[0], local["batch_size"], local["epochs"], cs)):
            grads, loss = step(params, xs[:, t], ys[:, t], ms[:, t])
            grads = exm.proximal_grad(grads, params, g32, pool.proximal_mu)
            updates, state = opt.update(grads, state, params)
            params = exm.apply_updates(params, updates)
            live = {k_: v.requires_grad_(True) for k_, v in ref.items()}
            i = torch.as_tensor(idx, device=device)
            rloss = loss_fn(ref_train.unflatten_like(live, g32), x[i], y[i],
                            config["model"])
            rgrads = torch.autograd.grad(rloss, list(live.values()))
            with torch.no_grad():
                ref = adam.step({k_: v.detach() for k_, v in live.items()},
                                dict(zip(live, rgrads)), rstate)
            if t % steps == 0 or t == xs.shape[1] - 1:
                p_row = fl.flat64(exm.tree_map(lambda v: v[row], params))
                r_row = fl.flat64(ref_train.unflatten_like(ref, g32))
                trace.append((t, float(loss[row]), float(rloss.detach()),
                              float((p_row - r_row).norm()
                                    / (r_row - g_flat).norm())))
    final = fl.flat64(exm.tree_map(lambda v: v[row], params))
    return {"trace": trace, "replica~captured": float(
        (final - cap_row(cap, cid).to(device).double()).norm()
        / (final - g_flat).norm())}


def cap_row(cap: dict, cid: str):
    return next(c["row"] for c in cap["clients"] if c["cid"] == cid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--trace-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--ensemble", type=int, default=0,
                    help="retrain each client whose mean loss parts from "
                    "the reference's by PARTED, and a run's first three "
                    "clients, this many times from moved params")
    ap.add_argument("--replay", type=int, default=0,
                    help="for the same clients: the program's executor "
                    "rerun on the round's group and on the client alone, "
                    "and this many float32 references with noise on every "
                    "gradient element (``replay``)")
    ap.add_argument("--lockstep", action="store_true",
                    help="for a client whose mean loss parts from the "
                    "reference's: the program's executor loop beside the "
                    "reference, step by step (``lockstep``)")
    args = ap.parse_args(argv)

    import gc

    import torch

    from bench_port import harness
    from bench_port.drivers import fl
    from bench_port.reference import train as ref_train
    from bench_port.reference import weights as ref_weights
    cell = harness.load_cell(args.workload)
    if cell.config["model"]["kind"] != "cnn":
        raise SystemExit("the look reads CNN cells")
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.trace_seeds]
    for seed, trace in runs:
        t = time.perf_counter()
        rec = fl.run(cell, seed, args.seconds, trace, device="cuda",
                     keep=True)
        captured, shards, driver = rec.kept
        print(json.dumps({
            "seed": seed, "trace": trace, "line": "run",
            "metrics": harness.metric_values(rec, trace),
            "peak_window_bytes": rec.peak_window_bytes,
            "checks": {k: c["value"] for k, c in rec.checks.items()},
            "look": rec.notes.get("look"),
            "round_s": rec.notes["round_s"],
            "paused_s": rec.notes["paused_s"],
            "setup_s": rec.setup_s, "s": time.perf_counter() - t}),
            flush=True)
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        for rnd, cap in sorted(captured.items()):
            g32 = ref_train.unflatten_like(
                {k: v.to("cuda") for k, v in
                 ref_weights.leaves(cap["g"]).items()}, cap["g"])
            for c in cap["clients"]:
                got = look_client(cell, g32, c, shards[c["cid"]], rnd, "cuda")
                print(json.dumps({"seed": seed, "line": "client", **got}),
                      flush=True)
                calm = (rnd, c) in [(r, x) for r, cp in sorted(
                    captured.items()) for x in cp["clients"]][:3]
                if args.ensemble and (
                        calm or got["prog~ref32.loss_gap"] > PARTED):
                    moved = ensemble(cell, g32, c, shards[c["cid"]], rnd,
                                     "cuda", args.ensemble)
                    print(json.dumps({"seed": seed, "line": "ensemble",
                                      "round": rnd, "cid": c["cid"],
                                      "moved": moved}), flush=True)
                if args.lockstep and got["prog~ref32.loss_gap"] > PARTED:
                    out = lockstep(cell, driver, cap, g32, c["cid"], shards,
                                   rnd, "cuda")
                    print(json.dumps({"seed": seed, "line": "lockstep",
                                      "round": rnd, "cid": c["cid"],
                                      **out}), flush=True)
                if args.replay and (
                        calm or got["prog~ref32.loss_gap"] > PARTED):
                    out = replay(cell, driver, cap, g32, c, shards, rnd,
                                 "cuda", args.replay)
                    print(json.dumps({"seed": seed, "line": "replay",
                                      "round": rnd, "cid": c["cid"],
                                      **out}), flush=True)
        del captured, shards, driver
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
