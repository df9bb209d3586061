"""The hybrid decoder's train step (Nemotron-H: Mamba2, MoE and attention
layers), ``models.make_train_step`` as ``launch/pretrain.py`` drives it
(traffic kind ``train_hybrid``).

As ``drivers/train.py`` runs the Mamba2 LM: set-up builds the step and
its state from the benchmark's weights (``reference/nemotron_h.py``) and
drives it through ``checked_steps`` steps on rows that all differ (also
its warm-up), keeping each step's loss, the first gradient's per-leaf
norms and the per-leaf norms of the params' change; the same object runs
the window, whole steps until ``seconds`` have passed; the traced run
profiles ``trace_steps`` more, with the program's spans filed
(``program_trace.reduce``) and each scan call recorded with its B/C
group count in the ``bc`` place (``ssd_scan_roofline.train``'s reader).

The port's config is the registry's ``nemotron-3-nano-30b-a3b`` with the
file's sizes, cut to its ``num_hidden_layers`` (its pattern's first
letters) and ``n_routed_experts`` held of the router's
``model.router_experts``.  The checked steps run with the program's
tracing on, so its counters give the routed pairs a step
(``moe.routed_pairs``, over the forward passes a step makes: two with
remat) for the window's model FLOPs (``flops_hybrid``).

The weights and the router are drawn from the mix's fixed
``weights_seed``, the token stream from the run's seed: every seed runs
the same model, so the routing, the experts' load and with them the
step's work do not follow the seed (with weights from the run's seed the
held experts took 124,539–183,873 pairs a step by seed, and the steps
spread by 1.1–1.6 % on an H100 80GB).

``correct``: once the window has closed and the program's state is freed,
``reference/nemotron_h.py`` runs the same checked steps from the same
weights on the same rows, in float32 with TF32 off, a sequence at a time,
and ``drivers/train.numbers_of`` holds the losses and the per-leaf norms
against it.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from bench_port import flops_hybrid
from bench_port.drivers import program
from bench_port.drivers.train import _rows, numbers_of
from bench_port.harness import RunRecord, judge
from bench_port.reference import Quant, control, fp32_exact
from bench_port.reference import nemotron_h as ref
from bench_port.reference import train as ref_train
from bench_port.reference import weights as ref_weights
from bench_port.traffic import generate

# the file's keys and the port's fields they set
_WIDTHS = (("hidden_size", "d_model"), ("vocab_size", "vocab"),
           ("num_attention_heads", "n_heads"),
           ("num_key_value_heads", "n_kv_heads"), ("head_dim", "head_dim"),
           ("moe_intermediate_size", "d_ff"),
           ("moe_shared_expert_intermediate_size", "shared_expert_ff"),
           ("num_experts_per_tok", "top_k"),
           ("routed_scaling_factor", "routed_scale"),
           ("mamba_num_heads", "ssm_n_heads"),
           ("mamba_head_dim", "ssm_head_dim"), ("n_groups", "ssm_groups"),
           ("ssm_state_size", "ssm_state"), ("conv_kernel", "ssm_conv"),
           ("norm_eps", "norm_eps"), ("n_routed_experts", "held_experts"))


def arch_config(config: dict, traffic: dict):
    """The port's ``ArchConfig`` of the configuration file at the mix's
    optimizer and switches: the registry's config with every size taken
    from the file, its pattern the file's first ``num_hidden_layers``
    letters and ``n_routed_experts`` held of the router's
    ``model.router_experts``."""
    from repro_torch.configs import get_config
    model = config["model"]
    kinds = tuple(ref.KINDS[c] for c in ref.pattern(config))
    cfg = get_config(model["arch"]).replace(
        n_layers=len(kinds), pattern=kinds,
        n_experts=model["router_experts"],
        dtype=config["precision"]["activations"],
        param_dtype=config["precision"]["params"],
        learning_rate=traffic["learning_rate"], optimizer=traffic["optimizer"],
        remat=traffic["remat"], efficient_ce=traffic["efficient_ce"],
        **{f: config[k] for k, f in _WIDTHS})
    if cfg.single_mixer is False or cfg.tie_embeddings:
        raise ValueError(f"the port's {model['arch']} is not a hybrid with "
                         f"an untied head")
    return cfg


def make_weights(config: dict, seed: int, device) -> dict:
    """The benchmark's weights from ``seed`` (the mix's ``weights_seed``),
    checked against the file's parameter count."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = ref.params(config, gen)
    n = ref_weights.count(params)
    if n != config["params"]:
        raise ValueError(f"{config['name']}: {n} params, the file says "
                         f"{config['params']}")
    return params


def _passes(traffic: dict) -> int:
    """Forward passes of a block a train step makes: remat reruns it."""
    return 2 if traffic["remat"] else 1


def run(cell, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: float = None) -> RunRecord:
    from repro_torch import tracing
    from repro_torch.models import make_train_step
    from repro_torch.optim import make_optimizer

    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    program.set_precision(config)
    cfg = arch_config(config, traffic)
    pool = generate.token_batches(config, traffic, seed)
    tokens = torch.as_tensor(pool.x, device=device)
    labels = torch.as_tensor(pool.y, device=device)
    B, S, n_pool = traffic["batch"], traffic["seq_len"], pool.x.shape[0]

    def batch_of(i):
        idx = torch.as_tensor(_rows(i, B, n_pool), device=device)
        return {"tokens": tokens[idx], "labels": labels[idx]}

    weights = make_weights(config, traffic["weights_seed"], device)
    train_step, _ = make_train_step(cfg)
    state = {"params": weights,
             "opt": make_optimizer(cfg.optimizer, cfg.learning_rate).init(
                 weights)}
    run = RunRecord(cell, "train", peak_precision=config["peak"])
    losses, grad1 = [], None
    n_checked = traffic["checked_steps"]
    tracing.enable()
    try:
        for i in range(n_checked):
            state, loss = train_step(state, batch_of(i))
            losses.append(loss)
            if i == 0:
                grad1 = {k: float(v.double().norm() / (1 - 0.9)) for k, v in
                         ref_weights.leaves(state["opt"]["m"]).items()}
    finally:
        tracing.enable(False)
    _, counts = tracing.drain()
    pairs = counts.get("moe.routed_pairs", 0) / (n_checked
                                                 * _passes(traffic))
    p0 = ref_weights.leaves(weights)
    change = {k: float((v.double() - p0[k].double()).norm()) for k, v in
              ref_weights.leaves(state["params"]).items()}
    losses = [float(x) for x in losses]
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
    run.tokens = n * B * S
    run.model_flops = n * flops_hybrid.train_flops(config, B, S, pairs)
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
        run.peak_bytes = max(setup_peak, run.peak_window_bytes)
    if trace:
        run.trace = _traced_steps(train_step, state, batch_of, step,
                                  traffic["trace_steps"], run.spans)
    run.notes = {"steps": n, "window_s": run.window_s,
                 "setup_s": run.setup_s, "checked_losses": losses,
                 "routed_pairs_per_step": pairs,
                 "passes_per_step": _passes(traffic)}
    del state, done
    if cuda:
        torch.cuda.empty_cache()
    numbers = numbers_of(losses, grad1, change,
                         *reference_steps(cell, seed, device))
    run.checks = judge(numbers, cell.limits)
    run.notes["look"] = {k: v for k, v in numbers.items()
                         if k not in cell.limits}
    return run


def _record_scans(calls: dict):
    """The scan calls' shapes while a trace runs, B/C's group count (1
    for a head-broadcast view) in the ``bc`` place; returns the undo."""
    import importlib
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    scan = ss._scan

    def rec_scan(x, a_dt, B, C, chunk, return_state):
        b, l, h, p = x.shape
        calls.setdefault("ssd_scan", []).append(
            (b, l, h, p, B.shape[-1], x.element_size(),
             1 if B.stride(2) == 0 else B.shape[2]))
        return scan(x, a_dt, B, C, chunk, return_state)

    ss._scan = rec_scan

    def undo():
        ss._scan = scan
    return undo


def _traced_steps(train_step, state, batch_of, first, n, spans):
    from torch.profiler import ProfilerActivity, profile

    from bench_port import program_trace
    from bench_port import trace as tr
    from repro_torch import tracing
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()
    calls: dict = {}
    undo = _record_scans(calls)
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
    out = program_trace.reduce(prof, tracing.SPANS)
    out.calls = calls
    return out


def reference_steps(cell, seed: int, device, precision: str = None):
    """The reference's checked steps from the benchmark's weights (the
    mix's ``weights_seed``) on the rows of ``seed``: each step's loss, the
    first step's per-leaf gradient norms and the per-leaf norms of the
    change after the steps; in float32 with TF32 off, or in a control
    ``precision`` (reference.control)."""
    config, traffic = cell.config, cell.traffic
    ctx, q = (control(precision, device) if precision
              else (fp32_exact(), Quant()))
    pool = generate.token_batches(config, traffic, seed)
    tokens = torch.as_tensor(pool.x, device=device)
    labels = torch.as_tensor(pool.y, device=device)
    weights = make_weights(config, traffic["weights_seed"], device)
    p0 = ref_weights.leaves(weights)
    params = dict(p0)
    opt = ref_train.Adam(traffic["learning_rate"])
    state = opt.init(params)
    losses, grad1 = [], None
    with ctx:
        for i in range(traffic["checked_steps"]):
            idx = torch.as_tensor(_rows(i, traffic["batch"],
                                        pool.x.shape[0]), device=device)
            loss, grads = ref.step_grads(params, weights, tokens[idx],
                                         labels[idx], config, q)
            if i == 0:
                grad1 = {k: float(g.double().norm()) for k, g in
                         grads.items()}
            with torch.no_grad():
                params = opt.step(params, grads, state)
            losses.append(loss)
            del grads
    change = {k: float((v.double() - p0[k].double()).norm())
              for k, v in params.items()}
    return losses, grad1, change


def readings(cell, seed: int, device) -> Dict[str, dict]:
    """The control (the reference in the file's ``control_precision``)
    and the faults of a step (half the batch, the state unchanged), each
    in the reference put in the program's place, against the float32
    reference: the readings the limits are set from
    (``calibrate_hybrid.py``)."""
    import copy
    want = reference_steps(cell, seed, device)
    out = {"control": numbers_of(*reference_steps(
        cell, seed, device, cell.config["control_precision"]), *want)}
    half = copy.deepcopy(cell)
    half.traffic["batch"] //= 2
    out["half_batch"] = numbers_of(*reference_steps(half, seed, device),
                                   *want)
    losses, grad1, change = want
    out["unchanged"] = numbers_of(losses, grad1, {k: 0.0 for k in change},
                                  *want)
    return out
