"""FL rounds through the port's training driver (traffic kind ``fl``).

Set-up: the clients' shards and the weights from the seed, the FL
schedule (cohorts, stragglers, their arrivals, the local shuffles) from
the mix's fixed ``schedule_seed``, so that every seed gives the same
rounds and arrivals on other data and weights; the driver
wired by ``fl/experiment.run_experiment`` itself (its ``Controller`` is
taken before its round loop starts), the executor warmed at the cell's
bucket (``executor_warmup``).  The window runs whole rounds through
``TrainingDriver.run_round``, evaluation off, and closes at the first
round boundary at or after ``seconds``, after a synchronize.  The traced
run then profiles ``trace_rounds`` more rounds.

``correct``: the rounds of the mix's ``check`` (round 0, from the
benchmark's own weights, and a later one; the same rounds for every seed)
are checked once the window has closed.  As a checked round ends, with
the window's clock stopped, the harness draws a sample of its trained
clients from the seed and copies their rows, the merge's rows and output
and the round's global params to the host, and lets the round's update
batches go: the device holds only what the program holds.  For each
sampled client the reference retrains the client from that round's
global params on the same shard and shuffle, in float32 with TF32 off,
and ``client_gaps`` holds the program's answers against it; the round's
merge is held against Eq. 3 over the rows the merge was given.  The
later round's global params are the program's own state (the previous
merge's output): the reference follows from there, round 0 checks the
start, and the merge check the stage in between.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_port import flops
from bench_port.drivers import program
from bench_port.harness import RunRecord, Spans, judge
from bench_port.reference import fp32_exact
from bench_port.reference import train as ref_train
from bench_port.reference import weights as ref_weights
from bench_port.traffic import generate

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by rounding alone (as a key's bias under
# softmax): its change is not compared
GRAD_FLOOR = 1e-3


def _driver(task, parts, cfg, weights, device):
    """``run_experiment``'s wiring of the driver, taken before its round
    loop: returns the ``TrainingDriver`` after the executor's warm-up."""
    from repro_torch.fl import experiment

    made = {}
    real = experiment.Controller

    def capture(*args, **kw):
        controller = real(*args, **kw)
        made["driver"] = controller

        def no_rounds(params, n_rounds, **_):
            return params, None
        controller.run = no_rounds
        return controller

    experiment.Controller = capture
    try:
        experiment.run_experiment(task, parts, None, cfg,
                                  initial_params=weights, device=device)
    finally:
        experiment.Controller = real
    del made["driver"].run
    return made["driver"]


def build(cell, seed: int, device) -> dict:
    """The cell's task, shards, weights and wired driver."""
    from repro_torch.data.synthetic import ArrayDataset
    from repro_torch.fl.experiment import ExperimentConfig, ScenarioConfig
    from repro_torch.fl.tasks import ClassificationTask, TaskConfig

    config, traffic = cell.config, cell.traffic
    program.set_precision(config)
    shards = generate.client_shards(config["model"], traffic, seed)
    weights = program.make_weights(config, seed, device)
    local = traffic["local"]
    task = ClassificationTask(
        program.model_def(config),
        TaskConfig(epochs=local["epochs"], batch_size=local["batch_size"],
                   learning_rate=local["learning_rate"],
                   optimizer=local["optimizer"],
                   per_sample_time_s=local["per_sample_time_s"]),
        device=device)
    parts = {cid: ArrayDataset(s.x, s.y) for cid, s in shards.items()}
    cfg = ExperimentConfig(
        strategy=traffic["strategy"], mode=traffic["mode"],
        n_rounds=traffic["study_rounds"],
        clients_per_round=traffic["clients_per_round"], tau=traffic["tau"],
        eval_every=0, seed=traffic["schedule_seed"], vectorized=True,
        executor_warmup=True,
        scenario=ScenarioConfig(
            straggler_fraction=traffic["straggler_fraction"],
            slow_share=traffic["slow_share"],
            slow_factor=traffic["slow_factor"],
            round_timeout_s=traffic["round_timeout_s"],
            seed=traffic["schedule_seed"]))
    driver = _driver(task, parts, cfg, weights, device)
    if torch.device(device).type == "cuda":
        # the merge kernel's library is built or loaded at its first
        # call: make that call here, at the model's P, not in round 0
        from repro_torch.kernels import fed_agg
        rows = torch.zeros(2, config["params"], device=device)
        fed_agg(rows, torch.full((2,), 0.5, device=device))
        del rows
    return {"task": task, "shards": shards, "weights": weights,
            "driver": driver}


class _Taps:
    """The harness's spans and captures around the program's calls: the
    executor's group dispatches (rows, losses, samples trained), the
    first local step's gradients as its optimizer gets them, its
    dispatch-time counter, the strategy's aggregate and the merge."""

    def __init__(self, driver, spans: Spans, checked_rounds, steps_of):
        self.round = -1
        self.checked = set(checked_rounds)
        self.batches: Dict[int, list] = {}     # checked round -> batches
        self.merges: Dict[int, tuple] = {}     # checked round -> merge
        self.losses: Dict[int, list] = {}      # round -> loss tensors
        self.samples: Dict[int, int] = {}      # round -> samples trained
        self.dispatch: List[float] = []
        self.group_steps: List[int] = []
        self.grad_norms: Dict[int, list] = {}  # checked round -> groups
        ex = driver.pool.executor
        task = driver.pool.task
        opt = task.optimizer

        def tapped_update(grads, state, params):
            # the first local step of a checked round's group: each
            # client's per-leaf gradient norm, as the optimizer gets it
            if self.round in self.checked and state["count"] == 0:
                self.grad_norms.setdefault(self.round, []).append(
                    {k: v.detach().reshape(v.shape[0], -1).double().norm(
                        dim=1) for k, v in ref_weights.leaves(grads).items()})
            return opt.update(grads, state, params)

        task.optimizer = type(opt)(opt.init, tapped_update)
        strategy = driver.strategy
        run_group_batch, lap, merge = ex.run_group_batch, ex._lap, \
            strategy.merger.merge

        def tapped_group(cids, datasets, global_params, mu, seeds):
            batch = run_group_batch(cids, datasets, global_params, mu, seeds)
            self.losses.setdefault(self.round, []).append(batch._losses)
            self.samples[self.round] = self.samples.get(self.round, 0) + \
                sum(len(d) for d in datasets)
            self.group_steps.append(steps_of(datasets[0]))
            if self.round in self.checked:
                self.batches.setdefault(self.round, []).append(batch)
            return batch

        def tapped_lap(t0):
            out = lap(t0)
            if out is not None:
                self.dispatch.append(out)
            return out

        def tapped_merge(global_params, updates, coeffs, mix=1.0):
            out = merge(global_params, updates, coeffs, mix)
            if self.round in self.checked:
                self.merges[self.round] = (global_params, list(updates), out)
            return out

        ex.run_group_batch = tapped_group
        ex._lap = tapped_lap
        ex.run_clients = spans.wrap("executor", ex.run_clients)
        strategy.merger.merge = tapped_merge
        strategy.aggregate = spans.wrap("aggregate", strategy.aggregate)

    def capture(self, rnd: int, g: dict, rng, m: int) -> dict:
        """A checked round's answers on the host: ``m`` of its trained
        clients drawn from ``rng`` (row, mean loss, first-step gradient
        norms), the merge's rows and output, and the global params ``g``
        the round started from; the round's batches are let go."""
        batches = self.batches.pop(rnd, [])
        norms = self.grad_norms.pop(rnd, [])
        rows = [(b, i, cid) for b, batch in enumerate(batches)
                for i, cid in enumerate(batch.cids)]
        pick = rng.choice(len(rows), size=min(m, len(rows)),
                          replace=False) if rows else []
        clients = []
        for j in sorted(pick):
            b, i, cid = rows[j]
            clients.append({"cid": cid, "row": batches[b].row(i).cpu(),
                            "loss": float(batches[b]._losses[i]),
                            "grad": {k: float(v[i])
                                     for k, v in norms[b].items()}})
        merge = self.merges.pop(rnd, None)
        if merge is not None:
            _, updates, out = merge
            merge = ([(u.flat_params().cpu(), u.round_number, u.client_id)
                      for u in updates], ref_weights.flat(out).cpu())
        host = {k: v.detach().cpu() for k, v in
                ref_weights.leaves(g).items()}
        return {"g": ref_train.unflatten_like(host, g), "clients": clients,
                "merge": merge, "groups": [list(b.cids) for b in batches]}


def _record_calls(calls: dict):
    """Shapes of the kernel calls while a trace runs (the harness's spans
    around the calls into the kernels layer); returns the undo."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.fed_agg")
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    into, scan = fa._fed_agg_into, ss._scan

    def rec_into(updates, coeffs, out):
        calls.setdefault("fed_agg", []).append(
            (updates.shape[0], updates.shape[1], updates.element_size()))
        return into(updates, coeffs, out)

    def rec_scan(x, a_dt, B, C, chunk, return_state):
        b, l, h, p = x.shape
        calls.setdefault("ssd_scan", []).append(
            (b, l, h, p, B.shape[-1], x.element_size(),
             1 if B.stride(2) == 0 else h))
        return scan(x, a_dt, B, C, chunk, return_state)

    fa._fed_agg_into, ss._scan = rec_into, rec_scan

    def undo():
        fa._fed_agg_into, ss._scan = into, scan
    return undo


def _flops(config: dict, samples: int, traffic: dict) -> float:
    model = config["model"]
    epochs = traffic["local"]["epochs"]
    if model["kind"] == "cnn":
        return flops.cnn_train_flops(model, samples * epochs)
    seq = traffic["data"]["seq_len"]
    return flops.lm_train_flops(config["params"],
                                ref_weights.vocab_rows(model),
                                model["d_model"],
                                samples * epochs * seq, samples * epochs)


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None, keep: bool = False) -> RunRecord:
    """One run of the cell; with ``keep`` the record also holds the
    checked rounds' captures, the shards and the driver (``run.kept``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    traffic, config = cell.traffic, cell.config
    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed)
    checked_rounds = tuple(traffic["check"]["rounds"])
    m = traffic["check"]["clients_per_round_checked"]
    local = traffic["local"]

    def steps_of(ds):
        return local["epochs"] * -(-len(ds) // local["batch_size"])

    run = RunRecord(cell, "fl", peak_precision=config["peak"])
    made = build(cell, seed, device)
    driver = made["driver"]
    taps = _Taps(driver, run.spans, checked_rounds, steps_of)
    if trace:
        driver.pool.executor.collect_timing = True
    params = made.pop("weights")
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start

    rnd, stats, captured, paused = 0, [], {}, 0.0
    t0 = time.perf_counter()
    while True:
        taps.round = rnd
        g = params
        with run.spans("round"):
            params, st = driver.run_round(params, rnd)
        stats.append(st)
        if rnd in checked_rounds:
            # the harness's copies, with the window's clock stopped
            if cuda:
                torch.cuda.synchronize()
            tp = time.perf_counter()
            captured[rnd] = taps.capture(rnd, g, rng, m)
            paused += time.perf_counter() - tp
        del g
        rnd += 1
        if time.perf_counter() - t0 - paused >= seconds and \
                rnd > max(checked_rounds):
            break
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0 - paused
    run.units = rnd
    run.attempted = rnd
    run.model_flops = sum(_flops(config, taps.samples.get(r, 0), traffic)
                          for r in range(rnd))
    run.dispatch_s = list(taps.dispatch)
    run.group_steps = list(taps.group_steps)
    run.window_span_s = {k: sum(v) for k, v in run.spans.seconds.items()}
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        run.peak_bytes = max(setup_peak, run.peak_window_bytes)
    # a round failed if it raised (it would have ended the run) or a
    # client's loss is not finite
    run.failed = sum(
        1 for r in range(rnd)
        if any(not bool(torch.isfinite(t).all()) for t in taps.losses.get(
            r, []) if t is not None))

    if trace:
        run.trace = _traced_rounds(driver, taps, run.spans, params, rnd,
                                   traffic["trace_rounds"])
    run.notes = {
        "rounds": rnd, "window_s": run.window_s, "paused_s": paused,
        "merged": [s.aggregated_updates for s in stats],
        "crashed": sum(len(s.crashed) for s in stats),
        "late": sum(len(s.late) for s in stats),
        "eur": float(np.mean([s.eur for s in stats])),
        "virtual_s": float(sum(s.duration_s for s in stats)),
        "setup_s": run.setup_s, "checked_rounds": list(checked_rounds),
        "round_s": run.spans.seconds["round"][:rnd]}

    shards = made["shards"]
    if keep:
        run.kept = (captured, shards, driver)
    del made, driver, taps, params, stats
    if cuda:
        torch.cuda.empty_cache()
    numbers, _ = compare(cell, captured, shards, device)
    run.checks = judge(numbers, cell.limits)
    run.notes["look"] = {k: v for k, v in numbers.items()
                         if k not in cell.limits}
    return run


def _traced_rounds(driver, taps, spans, params, first, n):
    from torch.profiler import ProfilerActivity, profile

    from bench_port import trace as tr
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()
    calls: dict = {}
    undo = _record_calls(calls)
    spans.profiling = True
    try:
        sync()
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(tr.WINDOW_SPAN):
                for rnd in range(first, first + n):
                    taps.round = rnd
                    with spans("round"):
                        params, _ = driver.run_round(params, rnd)
                sync()
    finally:
        spans.profiling = False
        undo()
    out = tr.reduce(prof)
    out.calls = calls
    return out


def worst_leaf(got: Dict[str, float], want: Dict[str, float],
               keep=None) -> float:
    """The largest |got − want| over max(want, the median leaf's want),
    among the leaves ``keep`` (all when None)."""
    names = [k for k in want if keep is None or k in keep]
    med = float(np.median([want[k] for k in names]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
               for k in names)


def moving(grad: Dict[str, float]) -> set:
    """The leaves whose reference gradient is at least ``GRAD_FLOOR`` of
    the median leaf's: the others move under Adam by rounding alone."""
    med = float(np.median(list(grad.values())))
    return {k for k, v in grad.items() if v >= GRAD_FLOOR * med}


def reference_client(config: dict, local: dict, g: dict, x: torch.Tensor,
                     y: torch.Tensor, seed: int) -> Tuple:
    """The reference's answers for one client from global params ``g``,
    in the dtype of ``g`` and ``x``: its trained row (float64), the mean
    of its local losses, and the per-leaf norms of its first local
    step's gradient."""
    loss_fn = program.client_loss(config)
    model = config["model"]
    want, want_loss = ref_train.local_train(loss_fn, g, x, y, model, local,
                                            seed)
    first = ref_train.batch_schedule(x.shape[0], local["batch_size"],
                                     local["epochs"], seed)[0]
    i = torch.as_tensor(first, device=x.device)
    live = {k: v.detach().requires_grad_(True) for k, v in
            ref_weights.leaves(g).items()}
    grads = torch.autograd.grad(
        loss_fn(ref_train.unflatten_like(live, g), x[i], y[i], model),
        list(live.values()))
    grad = {k: float(t.double().norm()) for k, t in zip(live, grads)}
    return flat64(want), want_loss, grad


def flat64(tree: dict) -> torch.Tensor:
    return torch.cat([t.reshape(-1).double()
                      for t in ref_weights.leaves(tree).values()])


def gaps_between(got: Tuple, want: Tuple, g: dict) -> Dict[str, float]:
    """One client's answers ``got`` = (row, mean loss, first-step
    gradient norms) against ``want``, both trained from ``g``:

    - ``grad_gap``: the per-leaf norms of the first local step's gradient
      as the optimizer got it, by the worst leaf (``worst_leaf``);
    - ``change_gap`` / ``change_gap_median``: the per-leaf norms of the
      trained row's change from ``g``, by the worst and by the median of
      the ``moving`` leaves;
    - ``update_gap``: ‖Δgot − Δwant‖ / ‖Δwant‖ of the whole row;
    - ``loss_gap``: |mean local loss − the reference's| / the
      reference's."""
    got_flat, got_loss, got_grad = got
    w, want_loss, want_grad = want
    med = float(np.median(list(want_grad.values())))
    by_leaf = {k: abs(got_grad[k] - v) / max(v, med, 1e-30)
               for k, v in want_grad.items()}
    leaves = ref_weights.leaves(g)
    g_flat = flat64(g).to(w.device)
    sizes = [t.numel() for t in leaves.values()]
    got_flat = got_flat.to(w.device).double()
    got_change, want_change = (
        {k: float(d.norm()) for k, d in zip(leaves, torch.split(v - g_flat,
                                                                sizes))}
        for v in (got_flat, w))
    keep = moving(want_grad)
    med_change = float(np.median([want_change[k] for k in keep]))
    return {"grad_gap": worst_leaf(got_grad, want_grad),
            "grad_gap_median": float(np.median(list(by_leaf.values()))),
            **{f"grad_gap.{k}": v for k, v in by_leaf.items()},
            "change_gap": worst_leaf(got_change, want_change, keep),
            "change_gap_median": float(np.median([
                abs(got_change[k] - want_change[k])
                / max(want_change[k], med_change, 1e-30) for k in keep])),
            "update_gap": float((got_flat - w).norm()
                                / (w - g_flat).norm().clamp(min=1e-30)),
            "loss_gap": abs(got_loss - want_loss) / max(abs(want_loss),
                                                        1e-30)}


def client_gaps(config: dict, local: dict, got_flat: torch.Tensor,
                got_loss: float, got_grad: Dict[str, float], g: dict,
                x: torch.Tensor, y: torch.Tensor, seed: int
                ) -> Dict[str, float]:
    """One client's answers against the float32 reference, both from the
    round's global params ``g`` (``gaps_between``)."""
    want = reference_client(config, local, g, x, y, seed)
    return gaps_between((got_flat, got_loss, got_grad), want, g)


def summarize(per_client: List[Dict[str, float]], merge_gap=None
              ) -> Dict[str, float]:
    """The numbers that decide ``correct``: each client number by the
    worst checked client, ``grad_gap_client_median`` the median client's
    ``grad_gap``, and the worst merge's ``merge_gap`` (when given)."""
    worst: Dict[str, float] = {}
    for gaps in per_client:
        for k, v in gaps.items():
            worst[k] = max(worst.get(k, 0.0), v)
    nan = float("nan")
    worst.setdefault("grad_gap", nan)
    worst["grad_gap_client_median"] = float(np.median(
        [c["grad_gap"] for c in per_client])) if per_client else nan
    if merge_gap is not None:
        worst["merge_gap"] = merge_gap
    return worst


def compare(cell, captured: dict, shards, device
            ) -> Tuple[Dict[str, float], List[dict]]:
    """The numbers that decide ``correct`` (see the module's text and
    ``summarize``), and each checked client's gaps."""
    config, traffic = cell.config, cell.traffic
    per_client: List[dict] = []
    merge_gap = 0.0
    with fp32_exact():
        for rnd, cap in sorted(captured.items()):
            g = ref_train.unflatten_like(
                {k: v.to(device) for k, v in
                 ref_weights.leaves(cap["g"]).items()}, cap["g"])
            for c in cap["clients"]:
                s = shards[c["cid"]]
                x = torch.as_tensor(s.x, device=device)
                y = torch.as_tensor(s.y, device=device)
                gaps = client_gaps(config, traffic["local"],
                                   c["row"].to(device), c["loss"],
                                   c["grad"], g, x, y, ref_train.client_seed(
                                       c["cid"], rnd, traffic["schedule_seed"]))
                per_client.append({"round": rnd, "cid": c["cid"], **gaps})
            merge_gap = max(merge_gap, _merge_gap(
                cap["merge"], g, rnd, shards, traffic["tau"], device))
    numbers = summarize([{k: v for k, v in c.items()
                          if k not in ("round", "cid")} for c in per_client],
                        merge_gap)
    return numbers, per_client


def _merge_gap(merge, g, rnd: int, shards, tau: int, device) -> float:
    """max |merged − Eq. 3 of the merge's rows| over max |Eq. 3|; with no
    update younger than τ the global params must come back unchanged."""
    if merge is None:
        return float("nan")
    updates, out = merge
    got = out.to(device).double()
    if not updates or all(rnd - r >= tau for _, r, _ in updates):
        want = ref_weights.flat(g).double()
    else:
        want = ref_train.fedlesscan_merge(
            [row.to(device) for row, _, _ in updates],
            [r for _, r, _ in updates],
            [len(shards[cid]) for _, _, cid in updates], rnd, tau)
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))
