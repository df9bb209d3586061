"""Training strategies: FedAvg, FedProx, FedLesScan, SAFA, FedAsync, FedBuff.

A Strategy owns (a) a `Scheduler` (fl/scheduler.py) that makes its
client-picking decisions — `Strategy.select` is a compatibility shim
delegating to it, and the training driver consumes the scheduler
directly — (b) the aggregation scheme, and (c) an optional client-side
loss hook (FedProx's proximal term).  The training driver
(fl/controller.py) is strategy-agnostic — this is the paper's `Strategy
Manager` component (§IV-A).

`Strategy.on_client_finish` is the single update-delivery path for every
training mode: the driver calls it whenever a client's update physically
arrives (at its true virtual time).  Barrier strategies return None and
aggregate at round close; barrier-free strategies (`barrier_free = True`)
may return a *new global model* from the hook itself — FedAsync merges
every arrival immediately with a staleness-damped mixing weight, FedBuff
flushes a size-K buffer.

Every merge — barrier round closes included — runs through the shared
delta-based `MergePipeline` (core/merge.py): the strategy supplies the
weighted-sum coefficients and a mixing rate, the pipeline forms the
pseudo-gradient against the current global model and applies it through
the configured server optimizer (`StrategyConfig.server_opt`: plain
server-SGD by default — byte-identical to the historical replace-with-
average — or FedAvgM / FedAdagrad / FedAdam / FedYogi with fp32 server
moments and the fused Pallas `fed_agg_apply` kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .aggregation import (ClientUpdate, UpdateStore, fedavg_coefficients,
                          staleness_coefficients, update_from_record,
                          update_to_record)
from .history import ClientHistoryDB
from .merge import MergePipeline, ServerOptConfig
from .selection import SelectionPlan

Pytree = Any


@dataclass
class StrategyConfig:
    clients_per_round: int = 10
    max_rounds: int = 50
    tau: int = 2                  # staleness cutoff (FedLesScan, paper §V-D)
    ema_alpha: float = 0.5
    fedprox_mu: float = 0.001     # proximal coefficient (FedProx)
    # barrier-free (async) strategies
    buffer_k: int = 4             # FedBuff aggregation buffer size
    async_alpha: float = 0.6      # FedAsync base mixing rate
    server_lr: float = 0.7        # FedBuff server rate: flush = (1-η)·global
                                  # + η·buffer average (η=1 → pure average)
    staleness_exponent: float = 0.5   # polynomial staleness damping a:
                                  # weight ∝ (staleness+1)^(-a)
    # server optimizer on the merge pipeline (core/merge.py): the default
    # identity (sgd, lr=1, no momentum) replaces the model with the
    # weighted average byte-identically to the pre-pipeline behaviour
    server_opt: str = "sgd"       # sgd|fedavgm|fedadagrad|fedadam|fedyogi
    server_opt_lr: float = 1.0
    server_opt_momentum: float = 0.0  # heavy-ball β (fedavgm defaults 0.9)
    server_opt_b1: float = 0.9
    server_opt_b2: float = 0.99
    server_opt_eps: float = 1e-3

    def server_opt_config(self) -> ServerOptConfig:
        return ServerOptConfig(
            name=self.server_opt, lr=self.server_opt_lr,
            momentum=self.server_opt_momentum, b1=self.server_opt_b1,
            b2=self.server_opt_b2, eps=self.server_opt_eps)


class Strategy:
    """Base class. Subclasses override selection/aggregation behaviour."""

    name = "base"
    uses_history = False          # does selection read behavioural data?
    semi_async = False            # accept late updates into later rounds?
    barrier_free = False          # merge on arrival (no round barrier)?

    def __init__(self, config: StrategyConfig, history: ClientHistoryDB,
                 seed: int = 0):
        self.config = config
        self.history = history
        self.rng = np.random.default_rng(seed)
        self.update_store = UpdateStore(tau=config.tau)
        self.last_plan: Optional[SelectionPlan] = None
        self.last_aggregate_count = 0   # updates actually merged last round
        # every strategy owns a Scheduler (fl/scheduler.py): the training
        # driver consumes it directly, and `select` delegates to it so
        # pre-scheduler call sites keep their exact behaviour (the
        # scheduler shares `self.rng`, preserving the sampling stream)
        self.scheduler = self._default_scheduler()
        # ... and a MergePipeline (core/merge.py): the single server-side
        # merge path for every aggregation this strategy performs
        self.merger = MergePipeline(config.server_opt_config())

    # ---- selection ------------------------------------------------------
    def _default_scheduler(self):
        # local import: core must stay importable before repro.fl loads
        from ..fl.scheduler import RandomScheduler
        return RandomScheduler(self.config.clients_per_round, rng=self.rng)

    def select(self, client_ids: Sequence[str], round_number: int) -> List[str]:
        """Compatibility shim: delegate to the strategy's scheduler."""
        want = self.scheduler.cohort_size(round_number, ())
        selected = self.scheduler.propose(client_ids, want, 0.0, round_number)
        self.last_plan = getattr(self.scheduler, "last_plan", None)
        return selected

    # ---- event hooks (controller is an event consumer) ------------------
    def on_client_finish(self, update: Optional[ClientUpdate],
                         arrival_time: float, producing_round: int,
                         current_round: int,
                         global_params: Optional[Pytree] = None
                         ) -> Optional[Pytree]:
        """A client's update physically arrived at `arrival_time` (virtual).

        This is the single delivery path for every training mode.  In
        barrier modes, same-round arrivals are collected by the driver and
        passed to `aggregate` at round close; an arrival from an *earlier*
        round is a straggler's update landing mid-flight — semi-async
        strategies cache it at its true arrival time, synchronous ones
        discard it.  In barrier-free (async) mode the driver additionally
        passes the current `global_params` and `producing_round`/
        `current_round` are *model versions*: a barrier-free strategy may
        return a new global model immediately (FedAsync) or after its
        buffer fills (FedBuff).  Returning None keeps the current model.
        """
        if (self.semi_async and update is not None
                and producing_round < current_round):
            self.accept_late_update(update, arrival_time=arrival_time)
        return None

    def on_round_close(self, round_number: int,
                       now: Optional[float] = None) -> None:
        """Called at the round's close time, before aggregation."""

    def finalize(self, global_params: Pytree,
                 current_round: int) -> Optional[Pytree]:
        """End of a barrier-free run: flush any partially-buffered state
        into a last global model (or None to keep the current one)."""
        return None

    def _staleness_merge(self, updates: Sequence[ClientUpdate],
                         round_number: int, now: Optional[float],
                         global_params: Optional[Pytree] = None
                         ) -> Optional[Pytree]:
        """Shared semi-async aggregation body: merge the round's in-time
        updates with cached late updates that have arrived by `now`
        (pop_for_round already enforces the τ cutoff), apply Eq. 3
        through the merge pipeline."""
        pending = self.update_store.pop_for_round(round_number, now)
        merged = list(updates) + pending
        self.last_aggregate_count = len(merged)
        fresh = [u for u in merged
                 if (round_number - u.round_number) < self.config.tau]
        if not fresh:
            # zero-update merge: the pipeline keeps the model unchanged
            return self.merger.merge(global_params, [], ())
        return self.merger.merge(global_params, fresh,
                                 staleness_coefficients(fresh, round_number))

    def accept_late_update(self, update: ClientUpdate,
                           arrival_time: float = 0.0) -> None:
        """Semi-async path: a straggler finished after its round closed;
        its update is cached and dampened into a later aggregation."""
        self.update_store.push(update, arrival_time)

    # ---- aggregation ----------------------------------------------------
    def aggregate(self, updates: Sequence[ClientUpdate], round_number: int,
                  now: Optional[float] = None,
                  global_params: Optional[Pytree] = None
                  ) -> Optional[Pytree]:
        """Return the new global model, or the unchanged `global_params`
        (None when the caller didn't pass them) on an empty merge."""
        self.last_aggregate_count = len(updates)
        if not updates:
            return self.merger.merge(global_params, [], ())
        return self.merger.merge(global_params, list(updates),
                                 fedavg_coefficients(updates))

    # ---- client-side hooks ----------------------------------------------
    def proximal_mu(self) -> float:
        """FedProx adds mu/2 ||w - w_global||^2 to the local loss; other
        strategies return 0.0 (no-op)."""
        return 0.0

    # ---- checkpoint surface (fl/checkpointing.py) -----------------------
    def state_dict(self, arrays: Optional[dict] = None) -> dict:
        """JSON-ready snapshot of the strategy's mutable state: the RNG
        stream, the last merge count, and the semi-async update store's
        pending (arrived-but-unmerged / still-in-flight) updates.  Update
        pytrees are deposited into `arrays` under ``strategy/...`` keys
        (they share the global model's tree structure) and saved next to
        the checkpoint params."""
        arrays = {} if arrays is None else arrays
        return {"rng": self.rng.bit_generator.state,
                "last_aggregate_count": self.last_aggregate_count,
                "pending": self.update_store.state_dict(arrays),
                "merger": self.merger.state_dict(arrays)}

    def load_state_dict(self, state: dict,
                        arrays: Optional[dict] = None) -> None:
        arrays = {} if arrays is None else arrays
        if "rng" in state:
            self.rng.bit_generator.state = state["rng"]
        self.last_aggregate_count = int(state.get("last_aggregate_count", 0))
        self.update_store.load_state_dict(state.get("pending", []), arrays)
        # absent in moment-free (pre-pipeline) checkpoints: the optimizer
        # restores fresh and moments re-accumulate from the resume point
        self.merger.load_state_dict(state.get("merger", {}), arrays)


class FedAvg(Strategy):
    """McMahan et al. — random selection (RandomScheduler) +
    cardinality-weighted averaging.  Synchronous: late updates are
    discarded."""

    name = "fedavg"


class FedProx(FedAvg):
    """Sahu/Li et al. — FedAvg + proximal term in the client loss.
    Selection remains random (the paper notes this makes it straggler-
    sensitive)."""

    name = "fedprox"

    def proximal_mu(self) -> float:
        return self.config.fedprox_mu


class FedLesScan(Strategy):
    """The paper's strategy: tiered clustering-based selection (Alg. 2)
    + staleness-aware aggregation (Eq. 3) over a semi-async update store."""

    name = "fedlesscan"
    uses_history = True
    semi_async = True

    def _default_scheduler(self):
        from ..fl.scheduler import FedLesScanScheduler
        return FedLesScanScheduler(
            self.config.clients_per_round, self.history,
            max_rounds=self.config.max_rounds,
            ema_alpha=self.config.ema_alpha, rng=self.rng)

    def aggregate(self, updates, round_number, now=None,
                  global_params=None):
        # include late updates from previous rounds that have ARRIVED by
        # now (in-flight ones stay queued; aged-out ones are dropped)
        return self._staleness_merge(updates, round_number, now,
                                     global_params)


class SAFA(Strategy):
    """Wu et al. [26] — the semi-asynchronous competitor the paper
    contrasts with (§III-B): invoke ALL clients every round, close the
    round at the k-th fastest response (k = clients_per_round), cache
    slower responses for subsequent rounds.  Communication/invocation
    cost is deliberately high — that's the trade-off the paper calls out.
    """

    name = "safa"
    semi_async = True
    invoke_all = True                 # controller invokes every client

    @property
    def quorum(self) -> int:
        return self.config.clients_per_round

    def _default_scheduler(self):
        from ..fl.scheduler import FullPoolScheduler
        return FullPoolScheduler(self.config.clients_per_round, rng=self.rng)

    def aggregate(self, updates, round_number, now=None,
                  global_params=None):
        return self._staleness_merge(updates, round_number, now,
                                     global_params)


def _staleness_weight(staleness: int, exponent: float) -> float:
    """Polynomial staleness damping (Xie et al., FedAsync): an update
    trained `staleness` model versions ago gets weight (s+1)^(-a)."""
    return float(staleness + 1) ** (-exponent)


class FedAsync(Strategy):
    """Xie et al. (arXiv:1903.03934) — fully-asynchronous FL: every
    arriving update is merged into the global model *immediately*,

        w ← (1 − α_s) · w + α_s · w_k,   α_s = α · (s+1)^(-a)

    where s is the update's staleness in model versions.  Barrier-free:
    requires the driver's async mode (the flwr-serverless regime,
    arXiv:2310.15329)."""

    name = "fedasync"
    barrier_free = True

    def on_client_finish(self, update, arrival_time, producing_round,
                         current_round, global_params=None):
        if update is None or global_params is None:
            return super().on_client_finish(
                update, arrival_time, producing_round, current_round)
        staleness = max(0, current_round - producing_round)
        alpha = (self.config.async_alpha
                 * _staleness_weight(staleness, self.config.staleness_exponent))
        self.last_aggregate_count = 1
        # merge pipeline with mix=α_s: identity server-opt folds the
        # global model in as the (1−α) anchor of one weighted sum
        return self.merger.merge(global_params, [update],
                                 np.array([1.0], dtype=np.float64),
                                 mix=alpha)


class FedBuff(Strategy):
    """Nguyen et al. (arXiv:2106.06639) — buffered asynchronous
    aggregation: arrivals accumulate in a size-K buffer; when it fills,
    the new global model is (1−η)·global + η·(staleness- and
    cardinality-weighted buffer average), computed as one weighted sum
    over the anchor + K buffered updates through the Pallas `fed_agg`
    fast path, and the buffer is cleared.  Barrier-free."""

    name = "fedbuff"
    barrier_free = True

    def __init__(self, config: StrategyConfig, history: ClientHistoryDB,
                 seed: int = 0):
        super().__init__(config, history, seed=seed)
        self._buffer: List[Tuple[int, ClientUpdate]] = []  # (staleness base)

    def _flush(self, global_params: Pytree,
               current_round: int) -> Pytree:
        eta = self.config.server_lr
        weights = np.array(
            [u.num_samples * _staleness_weight(
                max(0, current_round - produced),
                self.config.staleness_exponent)
             for produced, u in self._buffer], dtype=np.float64)
        total = weights.sum() or 1.0
        # pipeline with mix=η: identity server-opt reproduces the classic
        # (1−η)·global + η·buffer-average as one anchored weighted sum
        merged = self.merger.merge(global_params,
                                   [u for _, u in self._buffer],
                                   weights / total, mix=eta)
        self.last_aggregate_count = len(self._buffer)
        self._buffer.clear()
        return merged

    def on_client_finish(self, update, arrival_time, producing_round,
                         current_round, global_params=None):
        if update is None or global_params is None:
            return super().on_client_finish(
                update, arrival_time, producing_round, current_round)
        self._buffer.append((producing_round, update))
        if len(self._buffer) < self.config.buffer_k:
            return None
        return self._flush(global_params, current_round)

    def finalize(self, global_params, current_round):
        """Flush the trailing partial buffer so delivered-but-unmerged
        updates still reach the final global model."""
        if not self._buffer:
            return None
        return self._flush(global_params, current_round)

    def state_dict(self, arrays=None):
        """FedBuff's partial buffer is checkpoint state: an async snapshot
        can land with 0 < len(buffer) < K delivered-but-unmerged updates."""
        arrays = {} if arrays is None else arrays
        state = super().state_dict(arrays)
        buffered = []
        for i, (produced, u) in enumerate(self._buffer):
            arrays[f"strategy/buffer/{i}"] = u.params
            rec = update_to_record(u)
            rec["produced"] = produced
            buffered.append(rec)
        state["buffer"] = buffered
        return state

    def load_state_dict(self, state, arrays=None):
        arrays = {} if arrays is None else arrays
        super().load_state_dict(state, arrays)
        self._buffer = [
            (int(rec["produced"]),
             update_from_record(rec, arrays[f"strategy/buffer/{i}"]))
            for i, rec in enumerate(state.get("buffer", []))]


STRATEGIES = {cls.name: cls
              for cls in (FedAvg, FedProx, FedLesScan, SAFA,
                          FedAsync, FedBuff)}


def make_strategy(name: str, config: StrategyConfig,
                  history: ClientHistoryDB, seed: int = 0) -> Strategy:
    try:
        return STRATEGIES[name](config, history, seed=seed)
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; "
                         f"available: {sorted(STRATEGIES)}") from None
