"""The decoder's train step, ``models.make_train_step``, as
``launch/pretrain.py`` drives it (traffic kind ``train``).

Set-up builds one object, the step with its params and Adam state, from
the benchmark's weights, and drives it through ``checked_steps`` steps on
rows that all differ (these are also its warm-up): it keeps each step's
loss, the per-leaf norm of the first gradient as Adam got it
(m₁ / (1 − β₁)), and the per-leaf norm of the params' change after the
checked steps.  The same object then runs the window: whole steps until
``seconds`` have passed, synchronized at the end.  The traced run
profiles ``trace_steps`` more steps.

``correct``: once the window has closed and the program's state is
freed, the reference runs the same checked steps from the same weights
on the same rows, in float32 with TF32 off, a sequence at a time, and
the losses and both per-leaf norms are held against it (see
``compare``).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from bench_port import flops
from bench_port.drivers import program
from bench_port.drivers.fl import moving, worst_leaf
from bench_port.harness import RunRecord, judge
from bench_port.reference import Quant, control, fp32_exact
from bench_port.reference import train as ref_train
from bench_port.reference import weights as ref_weights
from bench_port.traffic import generate

def _rows(i: int, batch: int, pool: int) -> np.ndarray:
    return (np.arange(batch) + i * batch) % pool


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None) -> RunRecord:
    from repro_torch.models import make_train_step

    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    model = config["model"]
    program.set_precision(config)
    cfg = program.arch_config(model, config["precision"]).replace(
        learning_rate=traffic["learning_rate"], optimizer=traffic["optimizer"],
        remat=traffic["remat"], efficient_ce=traffic["efficient_ce"])
    pool = generate.token_batches(model, traffic, seed)
    tokens = torch.as_tensor(pool.x, device=device)
    labels = torch.as_tensor(pool.y, device=device)
    B, n_pool = traffic["batch"], pool.x.shape[0]

    def batch_of(i):
        idx = torch.as_tensor(_rows(i, B, n_pool), device=device)
        return {"tokens": tokens[idx], "labels": labels[idx]}

    weights = program.make_weights(config, seed, device)
    train_step, _ = make_train_step(cfg)
    from repro_torch.optim import make_optimizer
    state = {"params": weights,
             "opt": make_optimizer(cfg.optimizer, cfg.learning_rate).init(
                 weights)}
    run = RunRecord(cell, "train", peak_precision=config["peak"])
    # the checked steps, through the window's own call and feed
    losses, grad1 = [], None
    n_checked = traffic["checked_steps"]
    for i in range(n_checked):
        state, loss = train_step(state, batch_of(i))
        losses.append(loss)
        if i == 0:
            b1 = 0.9
            grad1 = {k: float(v.double().norm() / (1 - b1)) for k, v in
                     ref_weights.leaves(state["opt"]["m"]).items()}
    p0 = ref_weights.leaves(weights)
    change = {k: float((v.double() - p0[k].double()).norm()) for k, v in
              ref_weights.leaves(state["params"]).items()}
    losses = [float(x) for x in losses]
    # the benchmark's weights are the reference's to remake: the device
    # holds only the program's state through the window
    del p0, weights
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - t_start

    step, done = n_checked, []
    t0 = time.perf_counter()
    while True:
        with run.spans("batch"):
            batch = batch_of(step)
        with run.spans("step"):
            state, loss = train_step(state, batch)
        done.append(loss)
        step += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    n = step - n_checked
    run.units = run.attempted = n
    run.failed = sum(1 for x in torch.stack(done).tolist()
                     if not np.isfinite(x))
    run.tokens = n * B * traffic["seq_len"]
    run.model_flops = n * flops.lm_train_flops(
        config["params"], ref_weights.vocab_rows(model), model["d_model"],
        B * traffic["seq_len"], B * traffic["seq_len"])
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        run.peak_bytes = max(setup_peak, run.peak_window_bytes)
    if trace:
        run.trace = _traced_steps(train_step, state, batch_of, step,
                                  traffic["trace_steps"], run.spans)
    run.notes = {"steps": n, "window_s": run.window_s,
                 "setup_s": run.setup_s, "checked_losses": losses}
    del state, done
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(cell, seed, losses, grad1, change, device)
    run.checks = judge(numbers, cell.limits)
    run.notes["look"] = {k: v for k, v in numbers.items()
                         if k not in cell.limits}
    return run


def _traced_steps(train_step, state, batch_of, first, n, spans):
    from torch.profiler import ProfilerActivity, profile

    from bench_port import trace as tr
    from bench_port.drivers.fl import _record_calls
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
                for i in range(first, first + n):
                    with spans("batch"):
                        batch = batch_of(i)
                    with spans("step"):
                        state, _ = train_step(state, batch)
                sync()
    finally:
        spans.profiling = False
        undo()
    out = tr.reduce(prof)
    out.calls = calls
    return out


def reference_steps(cell, seed: int, device, precision: str = None):
    """The reference's checked steps from the benchmark's weights: each
    step's loss, the first step's per-leaf gradient norms and the
    per-leaf norms of the change after the steps; in float32 with TF32
    off, or in a control ``precision`` (reference.control)."""
    config, traffic = cell.config, cell.traffic
    model = config["model"]
    ctx, q = (control(precision, device) if precision
              else (fp32_exact(), Quant()))
    pool = generate.token_batches(model, traffic, seed)
    tokens = torch.as_tensor(pool.x, device=device)
    labels = torch.as_tensor(pool.y, device=device)
    weights = program.make_weights(config, seed, device)
    params = {k: v.clone() for k, v in ref_weights.leaves(weights).items()}
    opt = ref_train.Adam(traffic["learning_rate"])
    state = opt.init(params)
    losses, grad1 = [], None
    with ctx:
        for i in range(traffic["checked_steps"]):
            idx = torch.as_tensor(_rows(i, traffic["batch"],
                                        pool.x.shape[0]), device=device)
            loss, grads = ref_train.lm_step_grads(
                params, weights, tokens[idx], labels[idx], model, q)
            if i == 0:
                grad1 = {k: float(g.double().norm()) for k, g in
                         grads.items()}
            with torch.no_grad():
                params = opt.step(params, grads, state)
            losses.append(loss)
            del grads
    p0 = ref_weights.leaves(weights)
    change = {k: float((v.double() - p0[k].double()).norm())
              for k, v in params.items()}
    return losses, grad1, change


def compare(cell, seed: int, losses, grad1, change, device
            ) -> Dict[str, float]:
    ref_losses, ref_grad1, ref_change = reference_steps(cell, seed, device)
    return numbers_of(losses, grad1, change, ref_losses, ref_grad1,
                      ref_change)


def numbers_of(losses, grad1, change, ref_losses, ref_grad1, ref_change):
    """loss_gap: the worst step's relative loss gap; grad_gap: the worst
    leaf's gap of first-gradient norms; change_gap: the worst leaf's gap
    of the change's norms, over the leaves whose reference gradient is
    at least ``fl.GRAD_FLOOR`` of the median leaf's (``fl.moving``)."""
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": worst_leaf(grad1, ref_grad1),
            "change_gap": worst_leaf(change, ref_change, moving(ref_grad1))}
