"""Experiment harness — paper §VI-A4 scenarios.

standard     : deployed functions as-is; round timeout generous enough for
               healthy clients to finish.
straggler(%) : a fixed fraction of clients is made to straggle — half of
               them *slow* (finish after the round deadline: cold starts /
               bandwidth / weak VM) and half *crash* (never respond),
               matching the paper's two failure effects.

On the card (``vectorized=None`` with a CUDA device) each round's cohort
trains in the vectorized executor (fl/executor.py); on the CPU the eager
per-client loop runs unless ``vectorized=True``.  ``merge_devices`` and
``executor_devices`` shard the merge's P dim and the executor's cohort
over meshes of the cards (launch/mesh.py), clamped to how many exist.
``platforms`` spreads the clients over a fleet of simulated providers
(faas/profiles.py); ``checkpoint_dir`` / ``resume_from`` write and
resume full-fidelity checkpoints in the JAX package's file format
(fl/checkpointing.py).  ``compilation_cache_dir`` makes that directory the
hand-written kernels' build cache (launch/compile_cache.py), where the JAX
package points its compilation cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core.compress import CompressionConfig, UpdateCompressor
from ..core.flatten import tree_map
from ..core.history import ClientHistoryDB
from ..core.strategies import StrategyConfig, make_strategy
from ..data.synthetic import ArrayDataset
from ..device import DeviceLike, resolve_device
from ..faas.cost import CostMeter
from ..faas.invoker import MockInvoker
from ..faas.platform import ClientProfile, FaaSConfig, SimulatedFaaSPlatform
from ..faas.profiles import MultiPlatformInvoker
from ..faas.trace import TraceRecorder
from ..launch.mesh import make_clients_mesh, make_host_mesh
from .checkpointing import RoundCheckpointer
from .client import ClientPool
from .controller import Controller
from .tasks import ClassificationTask


@dataclass
class ScenarioConfig:
    straggler_fraction: float = 0.0   # 0.0 → standard scenario
    slow_share: float = 0.5           # of stragglers: slow vs crash
    slow_factor: float = 6.0          # slowdown multiplier for slow clients
    slow_factor_jitter: float = 0.0   # ± uniform jitter on slow_factor —
                                      # heterogeneous speeds make the
                                      # clustering component observable
    round_timeout_s: float = 120.0
    seed: int = 0


@dataclass
class ExperimentConfig:
    strategy: str = "fedlesscan"
    n_rounds: int = 30
    clients_per_round: int = 10
    tau: int = 2
    fedprox_mu: float = 0.001
    eval_every: int = 5
    seed: int = 0
    faas: FaaSConfig = field(default_factory=FaaSConfig)
    scenario: ScenarioConfig = field(default_factory=ScenarioConfig)
    # event-engine surface
    # vectorized client execution (fl/executor.py, one batched training
    # loop per round): None → on iff the device is CUDA; True also on CPU
    vectorized: Optional[bool] = None
    max_retries: int = 1              # FedLess invoker retry bound
    max_concurrency: Optional[int] = None   # per-round in-flight cap
    platforms: Optional[Dict[str, str]] = None  # client -> provider name
    default_platform: str = "gcf-gen2"
    # training-mode surface (fl/controller.TrainingDriver)
    # None → derived from the strategy: async for barrier-free strategies
    # (fedasync, fedbuff), semi-async/sync otherwise
    mode: Optional[str] = None
    trace_path: Optional[str] = None  # export the JSONL trace here
    # scheduling surface (fl/scheduler.py): None → the strategy's own
    # scheduler (barrier modes) / the rotation (async); a name from
    # make_scheduler ("random", "fedlesscan", "apodotiko", "adaptive",
    # "rotation") overrides the cohort policy in any mode
    scheduler: Optional[str] = None
    # checkpoint/resume surface (fl/checkpointing.py, all three modes):
    # write a full-fidelity snapshot to `checkpoint_dir` every
    # `checkpoint_every` rounds (barrier modes) or virtual *seconds*
    # (async mode — there is no round boundary); `resume_from` restores
    # the latest checkpoint in a directory and replays the remaining
    # timeline exactly, in-flight invocations included
    checkpoint_dir: Optional[str] = None
    checkpoint_every: float = 0
    resume_from: Optional[str] = None
    # retention: keep the trailing N tags plus the top-K by a RoundStats
    # metric (fl/checkpointing.RoundCheckpointer) so long async studies
    # don't accumulate unbounded npz/json pairs
    checkpoint_keep_last_n: int = 3
    checkpoint_keep_best: int = 0
    checkpoint_best_metric: str = "accuracy"
    # barrier-free strategy knobs (core/strategies.StrategyConfig)
    buffer_k: int = 4
    async_alpha: float = 0.6
    server_lr: float = 0.7
    staleness_exponent: float = 0.5
    # server optimizer on the merge pipeline (core/merge.py): "sgd"
    # (identity — byte-identical legacy behaviour), "fedavgm",
    # "fedadagrad", "fedadam", or "fedyogi", with its hyperparameters
    server_opt: str = "sgd"
    server_opt_lr: float = 1.0
    server_opt_momentum: float = 0.0
    server_opt_b1: float = 0.9
    server_opt_b2: float = 0.99
    server_opt_eps: float = 1e-3
    # client update compression (core/compress.UpdateCompressor): "none"
    # (dense — byte-identical legacy traces), "topk" (top-k magnitude
    # sparsification of the delta), or "int8" (per-chunk-scaled int8
    # quantization), with error-feedback residuals on by default
    compress_scheme: str = "none"
    compress_topk_ratio: float = 0.01
    compress_chunk: int = 256
    compress_error_feedback: bool = True
    # P-sharded merge: split the merge kernels' P dim over a host mesh of
    # this many cards (launch/mesh.make_host_mesh, clamped to the cards
    # that exist; 0/1 → unsharded)
    merge_devices: int = 0
    # cohort-sharded executor: split the vectorized executor's K dim over
    # a ("clients",) mesh of this many cards (make_clients_mesh, clamped;
    # 0/1 → unsharded).  Only read when `vectorized` resolves on.
    executor_devices: int = 0
    # stamp each executor group's wall-clock launch latency onto its
    # ClientUpdates / attempt trace records as `dispatch_s`
    # (only-when-set: default traces stay byte-identical)
    dispatch_timing: bool = False
    # run the executor once on round 0's cohort before the timed loop, so
    # first-call costs (cuDNN's algorithm choice) fall outside round 0
    executor_warmup: bool = False
    # the kernels' build directory (launch/compile_cache.py), where the
    # JAX package points its persistent compilation cache
    compilation_cache_dir: Optional[str] = None


def make_straggler_profiles(client_ids, scenario: ScenarioConfig
                            ) -> Dict[str, ClientProfile]:
    """Randomly designate `straggler_fraction` of clients as stragglers at
    experiment start (paper §VI-A4), split between slow and crashing."""
    rng = np.random.default_rng(scenario.seed)
    ids = list(client_ids)
    n_strag = int(round(scenario.straggler_fraction * len(ids)))
    chosen = rng.choice(ids, size=n_strag, replace=False) if n_strag else []
    profiles: Dict[str, ClientProfile] = {}
    for i, cid in enumerate(chosen):
        if i < int(round(n_strag * scenario.slow_share)):
            f = scenario.slow_factor
            if scenario.slow_factor_jitter:
                f += float(rng.uniform(-scenario.slow_factor_jitter,
                                       scenario.slow_factor_jitter))
            profiles[cid] = ClientProfile(slow_factor=max(1.0, f))
        else:
            profiles[cid] = ClientProfile(crash=True)
    return profiles


def run_experiment(task: ClassificationTask,
                   train_partitions: Dict[str, ArrayDataset],
                   test_partitions: Optional[Dict[str, ArrayDataset]],
                   config: ExperimentConfig,
                   initial_params=None,
                   verbose: bool = False,
                   device: DeviceLike = None,
                   return_params: bool = False):
    """Wire up platform → invoker → controller and run one experiment.

    ``device`` (``None`` means ``"cuda"``; raises when CUDA is absent)
    must be the task's device.  ``initial_params`` is a params tree; its
    leaves are copied to the device.  ``vectorized=None`` resolves to
    the vectorized executor on CUDA and to the eager per-client loop on
    the CPU.  Returns the ExperimentResult, or ``(final_params, result)``
    with ``return_params=True``.
    """
    dev = resolve_device(device)
    if task.device != dev:
        raise ValueError(f"the task runs on {task.device}, the experiment "
                         f"on {dev}")
    if config.compilation_cache_dir:
        from ..launch.compile_cache import enable_compilation_cache
        enable_compilation_cache(config.compilation_cache_dir)
    history = ClientHistoryDB()
    history.ensure(train_partitions.keys())

    strat_cfg = StrategyConfig(
        clients_per_round=config.clients_per_round,
        max_rounds=config.n_rounds, tau=config.tau,
        fedprox_mu=config.fedprox_mu, buffer_k=config.buffer_k,
        async_alpha=config.async_alpha, server_lr=config.server_lr,
        staleness_exponent=config.staleness_exponent,
        server_opt=config.server_opt,
        server_opt_lr=config.server_opt_lr,
        server_opt_momentum=config.server_opt_momentum,
        server_opt_b1=config.server_opt_b1,
        server_opt_b2=config.server_opt_b2,
        server_opt_eps=config.server_opt_eps)
    strategy = make_strategy(config.strategy, strat_cfg, history,
                             seed=config.seed)

    recorder = TraceRecorder() if config.trace_path else None
    compressor = None
    if config.compress_scheme != "none":
        compressor = UpdateCompressor(CompressionConfig(
            scheme=config.compress_scheme,
            topk_ratio=config.compress_topk_ratio,
            chunk=config.compress_chunk,
            error_feedback=config.compress_error_feedback))
    pool = ClientPool(task, train_partitions, test_partitions,
                      proximal_mu=strategy.proximal_mu(), seed=config.seed,
                      compressor=compressor)
    if config.merge_devices and config.merge_devices > 1:
        # clamps to the cards that exist (one card: size 1, unsharded)
        strategy.merger.mesh = make_host_mesh(data=config.merge_devices,
                                              device=dev)
    profiles = make_straggler_profiles(pool.client_ids, config.scenario)
    if config.platforms is not None:
        invoker = MultiPlatformInvoker(
            pool.work_fn, config.platforms, profiles,
            default=config.default_platform, seed=config.seed)
        if recorder is not None:
            invoker.fleet.attach_recorder(recorder)
    else:
        platform = SimulatedFaaSPlatform(config.faas, seed=config.seed,
                                         recorder=recorder)
        invoker = MockInvoker(platform, pool.work_fn, profiles)

    vectorized = (dev.type == "cuda" if config.vectorized is None
                  else config.vectorized)
    if vectorized:
        # the executor is cached on the task (shared across experiment
        # grids), so both knobs are set unconditionally: a later run with
        # defaults must not inherit an earlier run's mesh or timing
        mesh = (make_clients_mesh(config.executor_devices, device=dev)
                if config.executor_devices and config.executor_devices > 1
                else None)
        pool.executor.configure_mesh(mesh)
        pool.executor.collect_timing = bool(config.dispatch_timing)

    scheduler = None
    if config.scheduler is not None:
        from .scheduler import make_scheduler
        scheduler = make_scheduler(
            config.scheduler, config.clients_per_round, history=history,
            max_rounds=config.n_rounds, ema_alpha=strat_cfg.ema_alpha,
            client_ids=pool.client_ids,
            timeout_s=config.scenario.round_timeout_s, seed=config.seed)

    controller = Controller(
        strategy, invoker, pool, history, CostMeter(trace=recorder),
        round_timeout_s=config.scenario.round_timeout_s,
        eval_every=config.eval_every, seed=config.seed,
        max_retries=config.max_retries,
        max_concurrency=config.max_concurrency,
        vectorized=vectorized, mode=config.mode, trace=recorder,
        scheduler=scheduler)

    params = (tree_map(lambda t: t.to(dev), initial_params)
              if initial_params is not None
              else task.init_params(config.seed))

    start_round, checkpointer = 0, None
    if config.resume_from:
        # restored trees land on the device of `params`: the experiment's
        params, start_round = RoundCheckpointer(
            config.resume_from).restore(controller, params)
    if config.checkpoint_dir:
        checkpointer = RoundCheckpointer(
            config.checkpoint_dir,
            keep_last_n=config.checkpoint_keep_last_n,
            keep_best=config.checkpoint_keep_best,
            best_metric=config.checkpoint_best_metric)

    if config.executor_warmup:
        controller.warmup_executor(params)
    params, result = controller.run(params, config.n_rounds,
                                    verbose=verbose,
                                    start_round=start_round,
                                    checkpointer=checkpointer,
                                    checkpoint_every=config.checkpoint_every)
    if recorder is not None:
        recorder.to_jsonl(config.trace_path)
    return (params, result) if return_params else result
