"""TrainingDriver — mode-agnostic FL runtime on the shared event queue.

The FedLess controller (paper Algorithm 1, Train_Global_Model) is one
point on a sync→async spectrum.  This module runs all of it from a
single event loop over the shared `EventQueue`:

* ``sync`` / ``semi-async`` — today's round-barrier semantics: per round
  the driver asks the Strategy Manager for a cohort, hands it to the
  event-driven `InvocationEngine`, and drains the queue until the round
  closes (deadline, SAFA quorum's k-th success, or last in-time finish).
  Because the queue persists across rounds, a straggler's CLIENT_FINISH
  from round *t* fires during round *t+1* (or later) at its true
  virtual arrival time, and semi-async strategies receive it through
  `Strategy.on_client_finish` exactly then.  The two names share one
  code path; the mode label records whether the strategy accepts late
  updates.

* ``async`` — barrier-free (the Apodotiko / flwr-serverless regime):
  there is no round at all.  The driver keeps `clients_per_round`
  logical slots filled, re-invokes a client the moment a slot frees,
  and delivers every arrival to `Strategy.on_client_finish` with the
  current global model — barrier-free strategies (FedAsync, FedBuff)
  return a *new* global model from the hook and the driver versions it
  continuously.  Each invocation is its own engine ticket with its own
  crash-detection deadline; a slow client past its ticket deadline
  keeps running — its stale update merges on arrival with a
  staleness-damped weight while a replacement keeps throughput up.
  `RoundStats` entries are emitted per *aggregation event*, with EUR
  computed over the window between events (updates delivered /
  invocations resolved — `metrics.windowed_update_ratio`).

Every client-picking decision — sync round cohorts, semi-async refills,
and the async slot rotation with its exponential failure backoff —
lives in the `Scheduler` subsystem (fl/scheduler.py): the driver asks
``scheduler.cohort_size`` how many to invoke, ``scheduler.propose`` whom,
and reports every completion/miss back through ``notify_finish`` /
``notify_miss``.  Each propose is exported as a ``scheduling`` record in
the JSONL trace.  By default the barrier modes use the strategy's own
scheduler (the `Strategy.select` shim's engine) and the async mode a
`RotationScheduler`; pass `scheduler=` to race any policy in any mode.

`Controller` remains as a thin alias and `run_round`/`run` keep their
original signatures, so existing experiments, benchmarks and tests run
unmodified on the new driver.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .. import tracing
from ..core.history import ClientHistoryDB
from ..core.strategies import Strategy
from ..faas.cost import CostMeter
from ..faas.events import EventKind, EventQueue
from ..faas.invoker import ClientCompletion, InvocationEngine, MockInvoker
from .client import ClientPool
from .metrics import (bias, effective_update_ratio, weighted_accuracy,
                      windowed_update_ratio)
from .scheduler import (RotationScheduler, Scheduler,
                        StrategySelectScheduler,
                        scheduler_supports_exclude)

Pytree = Any

MODES = ("sync", "semi-async", "async")


@dataclass
class RoundStats:
    round_number: int
    selected: List[str]
    successes: List[str]
    late: List[str]
    crashed: List[str]
    duration_s: float
    eur: float
    cost: float
    accuracy: Optional[float] = None
    aggregated_updates: int = 0
    retries: int = 0
    # updates from earlier rounds that physically arrived during this round
    straggler_arrivals: List[str] = field(default_factory=list)


@dataclass
class ExperimentResult:
    strategy: str
    mode: str = "sync"
    rounds: List[RoundStats] = field(default_factory=list)
    final_accuracy: float = 0.0
    accuracy_curve: List[tuple] = field(default_factory=list)
    # cost attribution (CostMeter breakdown), populated by run()
    cost_by_client: Dict[str, float] = field(default_factory=dict)
    cost_by_round: Dict[int, float] = field(default_factory=dict)

    @property
    def total_duration_s(self) -> float:
        return sum(r.duration_s for r in self.rounds)

    @property
    def total_cost(self) -> float:
        return sum(r.cost for r in self.rounds)

    @property
    def mean_eur(self) -> float:
        """Barrier modes: the paper's mean of per-round EURs.  Async mode:
        the run-level merged/resolved ratio — averaging per-window ratios
        would overweight the (tiny, mostly-1.0) merge windows and dilute
        the crash probes concentrated in few windows."""
        if not self.rounds:
            return 1.0
        if self.mode == "async":
            delivered = sum(len(r.successes) for r in self.rounds)
            resolved = delivered + sum(len(r.crashed) for r in self.rounds)
            return windowed_update_ratio(delivered, resolved)
        return float(np.mean([r.eur for r in self.rounds]))

    def invocation_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self.rounds:
            for cid in r.selected:
                counts[cid] = counts.get(cid, 0) + 1
        return counts

    @property
    def bias(self) -> int:
        return bias(self.invocation_counts())


class _AsyncTicket:
    """One logical invocation in barrier-free mode."""

    __slots__ = ("client_id", "version", "deadline", "replaced")

    def __init__(self, client_id: str, version: int, deadline):
        self.client_id = client_id
        self.version = version          # model version the client trains on
        # crash-detection ROUND_DEADLINE event — None after a restore when
        # the deadline had already fired (late-but-alive ticket)
        self.deadline = deadline
        self.replaced = False           # slot already refilled at deadline?

    def cancel_deadline(self) -> None:
        if self.deadline is not None:
            self.deadline.cancel()


class TrainingDriver:
    """Mode-agnostic training runtime (see module docstring)."""

    def __init__(self, strategy: Strategy, invoker: MockInvoker,
                 pool: ClientPool, history: ClientHistoryDB,
                 cost_meter: Optional[CostMeter] = None,
                 round_timeout_s: float = 120.0,
                 eval_every: int = 5, eval_fraction: float = 0.2,
                 seed: int = 0, max_retries: int = 1,
                 max_concurrency: Optional[int] = None,
                 vectorized: bool = False,
                 mode: Optional[str] = None, trace=None,
                 scheduler: Optional[Scheduler] = None):
        self.strategy = strategy
        self.invoker = invoker
        self.pool = pool
        self.history = history
        self.cost = cost_meter or CostMeter()
        self.round_timeout_s = round_timeout_s
        self.eval_every = eval_every
        self.eval_fraction = eval_fraction
        self.rng = np.random.default_rng(seed)
        self.vectorized = vectorized
        self.platform = invoker.platform
        if mode is None:
            mode = ("async" if getattr(strategy, "barrier_free", False)
                    else "semi-async" if strategy.semi_async else "sync")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; available: {MODES}")
        if mode == "async" and not getattr(strategy, "barrier_free", False):
            raise ValueError(
                f"strategy {strategy.name!r} has a round barrier; async "
                f"mode needs a barrier-free strategy (fedasync, fedbuff)")
        self.mode = mode
        self.trace = trace
        # all cohort decisions route through one Scheduler: the strategy's
        # own (via the Strategy.select shim's engine) in barrier modes,
        # the deterministic rotation in barrier-free mode — or any policy
        # injected by the caller
        if scheduler is not None:
            self.scheduler = scheduler
        elif self.mode == "async":
            self.scheduler = RotationScheduler(
                strategy.config.clients_per_round, pool.client_ids,
                timeout_s=round_timeout_s, seed=seed)
        elif type(strategy).select is not Strategy.select:
            # legacy subclass with a hand-written select override: its
            # policy keeps winning over the default scheduler
            self.scheduler = StrategySelectScheduler(strategy)
        else:
            self.scheduler = strategy.scheduler
        self._recent_stats: List[RoundStats] = []   # cohort_size telemetry
        # legacy Strategy subclasses may override aggregate() without the
        # global_params kwarg (pre-merge-pipeline signature): detect once
        # and call them the old way — they keep their exact behaviour
        import inspect
        agg_params = inspect.signature(strategy.aggregate).parameters
        self._agg_takes_global = (
            "global_params" in agg_params
            or any(p.kind is p.VAR_KEYWORD for p in agg_params.values()))
        # one event queue on the platform's clock, shared across rounds —
        # straggler events survive round boundaries
        self.queue = EventQueue(self.platform.clock, recorder=trace)
        self.engine = InvocationEngine(invoker, max_retries=max_retries,
                                       max_concurrency=max_concurrency,
                                       recorder=trace)
        # barrier-free bookkeeping (tickets never collide with round ids);
        # a plain int so the counter position is checkpointable
        self._next_ticket = 1 << 20
        # mid-run async state: live during _run_async (the checkpoint
        # reads it), pre-loaded by restore_state for a resumed run
        self._async_live: Optional[Dict[str, Any]] = None
        self._async_resume: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------
    def _evaluate(self, params: Pytree) -> float:
        """Paper §VI-A5: accuracy on a random subset of clients' test sets,
        weighted by test cardinality."""
        clients = getattr(self.pool, "clients", {})
        ids = [cid for cid in self.pool.client_ids
               if getattr(clients.get(cid), "test_dataset", None) is not None]
        if not ids:
            return 0.0
        k = max(1, int(len(ids) * self.eval_fraction))
        sample = self.rng.choice(ids, size=min(k, len(ids)), replace=False)
        per_client = []
        for cid in sample:
            ds = self.pool.clients[cid].test_dataset
            acc, _ = self.pool.task.evaluate(params, ds)
            per_client.append((acc, len(ds)))
        return weighted_accuracy(per_client)

    def _print_progress(self, label: str, stats: RoundStats) -> None:
        acc = f" acc={stats.accuracy:.3f}" if stats.accuracy else ""
        print(f"[{self.strategy.name}] {label} {stats.round_number:3d} "
              f"eur={stats.eur:.2f} dur={stats.duration_s:6.1f}s "
              f"cost=${stats.cost:.4f}{acc}")

    def _record_aggregation(self, time: float, round_number: int,
                            merged: int, payload_bytes: Optional[int] = None,
                            dense_bytes: Optional[int] = None) -> None:
        if self.trace is None:
            return
        extra = {}
        merger = getattr(self.strategy, "merger", None)
        if merger is not None and not merger.is_identity:
            # server-opt metadata + ‖Δ‖₂ diagnostics ride the aggregation
            # record; the identity default adds nothing, keeping legacy
            # traces byte-identical (a zero-update merge reads norm 0.0)
            extra = {"server_opt": merger.config.name,
                     "server_steps": merger.steps,
                     "update_norm": merger.last_update_norm}
        if payload_bytes is not None:
            # compressed-update telemetry: total encoded wire bytes that
            # fed this merge and the achieved ratio vs dense fp32; dense
            # runs carry no payload and the record keeps its legacy keys
            extra["payload_bytes"] = int(payload_bytes)
            if dense_bytes:
                extra["compression_ratio"] = round(
                    float(dense_bytes) / float(payload_bytes), 4)
        self.trace.aggregation(time=time, round_number=round_number,
                               merged=merged,
                               strategy=self.strategy.name,
                               mode=self.mode, **extra)

    def _record_scheduling(self, time: float, round_number: int, want: int,
                           selected: List[str], pool_size: int) -> None:
        if self.trace is not None:
            self.trace.scheduling(time=time, round_number=round_number,
                                  scheduler=self.scheduler.name,
                                  mode=self.mode, want=want,
                                  selected=list(selected),
                                  pool_size=pool_size,
                                  **self.scheduler.decision_info())

    # ------------------------------------------------------------------
    # barrier path (sync / semi-async)
    # ------------------------------------------------------------------
    def _precompute_updates(self, selected: List[str], global_params: Pytree,
                            round_number: int) -> Optional[Dict[str, tuple]]:
        """Vectorized client execution: run every live selected client's
        local epochs as one vmapped dispatch (fl/executor.py) and feed the
        results to the engine as the per-client work cache."""
        if not (self.vectorized and hasattr(self.pool, "batch_work_fn")):
            return None
        # under a concurrency cap only the first `cap` clients fire at
        # round start — precompute just those; cap-released clients fall
        # back to the per-client work_fn when their slot opens
        cap = self.engine.max_concurrency or len(selected)
        profiles = getattr(self.invoker, "profiles", {})
        alive = [cid for cid in selected[:cap]
                 if not getattr(profiles.get(cid), "crash", False)]
        if not alive:
            return None
        return self.pool.batch_work_fn(alive, global_params, round_number)

    def warmup_executor(self, global_params: Pytree) -> int:
        """Opt-in compile warm-up (ExperimentConfig.executor_warmup):
        dispatch the vectorized executor once for the cohort-bucket
        shapes round 0 would use, so XLA compilation happens before the
        timed loop.  Touches no round state — no packaging, no
        compressor residuals, no history.  Returns the executor's
        cumulative compile count (0 when not vectorized)."""
        if not (self.vectorized and hasattr(self.pool, "batch_work_fn")
                and hasattr(self.pool, "executor")):
            return 0
        want = self.strategy.config.clients_per_round
        cids = list(self.pool.client_ids)[:want]
        if not cids:
            return 0
        return self.pool.executor.warmup(self.pool, cids, global_params)

    def _handle_straggler(self, completion: ClientCompletion,
                          arrival_time: float, current_round: int) -> float:
        """A client from an earlier round finished mid-flight: record its
        (client-side) report now and hand the update to the strategy at
        its true virtual arrival time (Alg. 1 lines 16-27).  Returns the
        egress cost of its (late) update upload."""
        out = completion.outcome
        self.history.client_report(out.client_id, completion.round_number,
                                   out.duration_s)
        self.scheduler.notify_finish(out.client_id, arrival_time,
                                     duration_s=out.duration_s,
                                     cold=out.cold, late=True)
        self.strategy.on_client_finish(
            completion.update, arrival_time=arrival_time,
            producing_round=completion.round_number,
            current_round=current_round)
        return self._charge_egress(completion.update, out.client_id,
                                   current_round)

    def _charge_egress(self, update, client_id: str, round_number) -> float:
        """Bill the update's encoded upload (no-op for dense updates)."""
        if update is None or update.payload_bytes is None:
            return 0.0
        return self.cost.charge_egress(update.payload_bytes,
                                       client_id=client_id,
                                       round_number=round_number)

    def _bill_attempts(self, completion: ClientCompletion,
                       round_number: int) -> float:
        """Every attempt of a retried invocation is billed (FedLess retries
        are real invocations on the provider's meter)."""
        return sum(self.cost.charge(fa.duration_s,
                                    client_id=completion.client_id,
                                    round_number=round_number)
                   for fa in completion.failed_attempts)

    def run_round(self, global_params: Pytree,
                  round_number: int) -> tuple:
        """One Train_Global_Model iteration. Returns (params, RoundStats)."""
        with tracing.span("fl.round", round=round_number):
            return self._barrier_round(global_params, round_number)

    def _barrier_round(self, global_params: Pytree,
                       round_number: int) -> tuple:
        if self.mode == "async":
            raise RuntimeError("run_round is a barrier API; the async mode "
                               "runs barrier-free — use run()")
        clock = self.queue.clock
        t0 = clock.now
        deadline = t0 + self.round_timeout_s

        # the Scheduler owns the cohort decision: how many (adaptive
        # sizing over trailing RoundStats) and whom
        want = self.scheduler.cohort_size(round_number, self._recent_stats)
        selected = self.scheduler.propose(self.pool.client_ids, want, t0,
                                          round_number)
        self.strategy.last_plan = getattr(self.scheduler, "last_plan",
                                          self.strategy.last_plan)
        self._record_scheduling(t0, round_number, want, selected,
                                len(self.pool.client_ids))
        # deferred, not eager: the engine runs the provider when the
        # round's first INVOKE_START fires — with overlapped dispatch
        # (REPRO_OVERLAP_DISPATCH, default on) the vmapped executor
        # launch returns unready device handles and the round's event /
        # trace / billing bookkeeping overlaps the device compute.  Same
        # virtual time, same client order → traces stay byte-identical
        # to the eager precompute.
        self.engine.open_round(
            self.queue, selected, global_params, round_number, t0,
            work_provider=lambda: self._precompute_updates(
                selected, global_params, round_number))
        deadline_ev = self.queue.schedule(deadline, EventKind.ROUND_DEADLINE,
                                          round_number=round_number)

        # SAFA-style dynamic quorum: the round closes at the k-th fastest
        # response instead of a fixed timeout (still capped by it).
        quorum = getattr(self.strategy, "quorum", None)

        successes: List[ClientCompletion] = []
        failed: List[ClientCompletion] = []
        straggler_arrivals: List[str] = []
        round_cost = 0.0
        retries = 0
        close_time = deadline

        while True:
            ev = self.queue.pop()
            if ev is None:
                break
            if ev.kind is EventKind.ROUND_DEADLINE:
                if ev.round_number == round_number:
                    break
                continue
            completion = self.engine.handle(self.queue, ev)
            if completion is None:
                continue
            if completion.round_number != round_number:
                # a straggler from an earlier round arriving mid-flight
                round_cost += self._bill_attempts(completion, round_number)
                if completion.success:
                    straggler_arrivals.append(completion.client_id)
                    round_cost += self._handle_straggler(completion, ev.time,
                                                         round_number)
                continue
            round_cost += self._bill_attempts(completion, round_number)
            retries += completion.attempts - 1
            if completion.success:
                successes.append(completion)
                self.strategy.on_client_finish(
                    completion.update, arrival_time=ev.time,
                    producing_round=round_number,
                    current_round=round_number)
                if quorum and len(successes) >= quorum:
                    close_time = ev.time
                    deadline_ev.cancel()
                    break
                if not failed and len(successes) == len(selected):
                    # everyone answered in time: close at the last finish
                    close_time = ev.time
                    deadline_ev.cancel()
                    break
            else:
                failed.append(completion)
            if (quorum
                    and self.engine.unresolved_count(round_number) == 0):
                # quorum unreachable — every remaining client resolved
                # observably, so the k-th response will never come; close
                # at the last terminal event instead of the full timeout
                close_time = ev.time
                deadline_ev.cancel()
                break

        late_ids, dead_ids, unstarted = self.engine.close_round(round_number,
                                                                close_time)
        duration = close_time - t0
        clock.advance_to(close_time)

        # --- controller-side history + billing (Alg. 1 lines 5-13) -----
        for comp in successes:
            out = comp.outcome
            self.history.mark_success(out.client_id, round_number)
            # client-side report (Alg. 1 lines 16-27) — in-time client
            self.history.client_report(out.client_id, round_number,
                                       out.duration_s)
            self.scheduler.notify_finish(out.client_id, close_time,
                                         duration_s=out.duration_s,
                                         cold=out.cold)
            round_cost += self.cost.charge(out.duration_s,
                                           client_id=out.client_id,
                                           round_number=round_number)
            # compressed runs also pay for shipping the encoded update
            round_cost += self._charge_egress(comp.update, out.client_id,
                                              round_number)
        for cid in late_ids:
            # alive but past the deadline: a miss now; its report and its
            # update arrive with its CLIENT_FINISH event in a later round
            self.history.mark_miss(cid, round_number)
            self.scheduler.notify_miss(cid, close_time, crashed=False)
            round_cost += self.cost.charge_straggler(duration, client_id=cid,
                                                     round_number=round_number)
        for comp in failed:
            self.history.mark_miss(comp.outcome.client_id, round_number)
            self.scheduler.notify_miss(comp.outcome.client_id, close_time)
            round_cost += self.cost.charge_straggler(
                duration, client_id=comp.outcome.client_id,
                round_number=round_number)
        for cid in dead_ids:
            self.history.mark_miss(cid, round_number)
            self.scheduler.notify_miss(cid, close_time)
            round_cost += self.cost.charge_straggler(duration, client_id=cid,
                                                     round_number=round_number)
        for cid in unstarted:
            # never invoked (concurrency cap): a miss, but nothing billed
            self.history.mark_miss(cid, round_number)
            self.scheduler.notify_miss(cid, close_time, crashed=False)

        # --- aggregation runs at round close (virtual now) --------------
        self.strategy.on_round_close(round_number, now=close_time)
        updates = [c.update for c in successes if c.update is not None]
        with tracing.span("fl.aggregate"):
            if self._agg_takes_global:
                new_params = self.strategy.aggregate(
                    updates, round_number, now=close_time,
                    global_params=global_params)
            else:                   # legacy pre-pipeline override
                new_params = self.strategy.aggregate(updates, round_number,
                                                     now=close_time)
        if new_params is None:
            new_params = global_params
        # wire-size telemetry for the aggregation record: every update the
        # strategy received this round (in-time + straggler arrivals);
        # dense updates carry no payload, so legacy records are unchanged
        carried = [u for u in updates if u.payload_bytes is not None]
        payload_total = (sum(u.payload_bytes for u in carried)
                         if carried else None)
        dense_total = sum(u.dense_bytes or 0 for u in carried)
        self._record_aggregation(close_time, round_number,
                                 self.strategy.last_aggregate_count,
                                 payload_bytes=payload_total,
                                 dense_bytes=dense_total)

        crashed_ids = ([c.outcome.client_id for c in failed]
                       + dead_ids + unstarted)
        stats = RoundStats(
            round_number=round_number, selected=list(selected),
            successes=[c.outcome.client_id for c in successes],
            late=late_ids, crashed=crashed_ids,
            duration_s=float(duration),
            eur=effective_update_ratio(len(successes), len(selected)),
            cost=round_cost,
            aggregated_updates=self.strategy.last_aggregate_count,
            retries=retries,
            straggler_arrivals=straggler_arrivals)
        # trailing telemetry window for Scheduler.cohort_size
        self._recent_stats.append(stats)
        del self._recent_stats[:-16]
        return new_params, stats

    # ------------------------------------------------------------------
    # barrier-free path (async)
    # ------------------------------------------------------------------
    def _run_async(self, global_params: Pytree, n_rounds: int,
                   verbose: bool = False, checkpointer=None,
                   checkpoint_every: float = 0.0) -> tuple:
        """Barrier-free loop: deliver `n_rounds × clients_per_round`
        updates (the same update budget a clean sync run would get),
        emitting one RoundStats window per aggregation event.

        All loop state lives in one dict `S` so a checkpoint can snapshot
        it between events: with a `checkpointer`, an event-horizon
        snapshot is written every `checkpoint_every` *virtual seconds*
        (there is no round boundary to count), and `restore_state`
        pre-loads `S` for a resumed run to continue mid-timeline."""
        cohort_size = self.strategy.config.clients_per_round
        # the vmapped executor batches a round cohort; one-client tickets
        # have no cohort, so async always trains through the per-client
        # work_fn (vectorized is a barrier-mode knob)
        clock = self.queue.clock
        S, self._async_resume = self._async_resume, None
        if S is not None:
            S["params"] = global_params      # restored by the checkpointer
        else:
            target = n_rounds * cohort_size
            S = {
                "target": target,
                "version": 0,        # global model version (bumps per merge)
                "delivered_total": 0,
                "next_eval": (self.eval_every * cohort_size
                              if self.eval_every else 0),
                # hard budget so a fully-dead population terminates instead
                # of probing forever: the queue drains once nothing new is
                # issued
                "issue_budget": (target * 20
                                 + 10 * len(self.pool.client_ids)),
                "issued_total": 0,
                "snapshots": 0,
                "tickets": {},       # tid -> _AsyncTicket
                "in_flight": set(),
                "window": self._fresh_window(clock.now),
                "result": ExperimentResult(strategy=self.strategy.name,
                                           mode=self.mode),
                "params": global_params,
            }
        self._async_live = S
        result = S["result"]
        tickets: Dict[int, _AsyncTicket] = S["tickets"]
        in_flight: set = S["in_flight"]
        next_ckpt = (clock.now + checkpoint_every
                     if checkpointer is not None and checkpoint_every > 0
                     else None)

        def issue(cid: str, when: float) -> None:
            if S["issued_total"] >= S["issue_budget"]:
                return
            S["issued_total"] += 1
            tid = self._next_ticket
            self._next_ticket += 1
            if self.trace is not None:
                # attempt records join billing/aggregation on model version
                self.trace.alias_round(tid, S["version"])
            self.engine.open_round(self.queue, [cid], S["params"], tid, when)
            dl = self.queue.schedule(when + self.round_timeout_s,
                                     EventKind.ROUND_DEADLINE,
                                     round_number=tid)
            tickets[tid] = _AsyncTicket(cid, S["version"], dl)
            in_flight.add(cid)
            S["window"]["issued"].append(cid)

        takes_exclude = scheduler_supports_exclude(self.scheduler)

        def propose(want: int, now: float) -> List[str]:
            """Ask the Scheduler for the next slot fill(s): the eligible
            pool excludes in-flight clients; rotation order, failure
            backoff, and any scoring live inside the scheduler.  With an
            exclude-aware scheduler the full population is passed and
            in-flight filtering happens vectorized inside — no O(N)
            eligible list per refill (in_flight ⊆ pool, so the reported
            pool size is unchanged)."""
            pool_ids = self.pool.client_ids
            if takes_exclude:
                picks = self.scheduler.propose(pool_ids, want, now,
                                               S["version"],
                                               exclude=in_flight)
                pool_size = len(pool_ids) - len(in_flight)
            else:
                eligible = [cid for cid in pool_ids
                            if cid not in in_flight]
                picks = self.scheduler.propose(eligible, want, now,
                                               S["version"])
                pool_size = len(eligible)
            self._record_scheduling(now, S["version"], want, picks,
                                    pool_size)
            return picks

        def refill(now: float) -> None:
            for cid in propose(1, now):
                issue(cid, now)

        def close_window(now: float, merged: int,
                         aggregated: bool = True) -> None:
            window = S["window"]
            stats = RoundStats(
                round_number=len(result.rounds),
                selected=list(window["issued"]),
                successes=list(window["delivered"]),
                late=list(window["late"]), crashed=list(window["crashed"]),
                duration_s=float(now - window["start"]),
                # denominator: invocations *resolved* this window (every
                # one of them was issued) — delivered updates plus wasted
                # crash/failure probes; telescopes to merged/issued over
                # the run without in-flight overhang distortion
                eur=windowed_update_ratio(
                    len(window["delivered"]),
                    len(window["delivered"]) + len(window["crashed"])),
                cost=self.cost.total - window["cost0"],
                aggregated_updates=merged, retries=window["retries"],
                straggler_arrivals=list(window["straggler_arrivals"]))
            if aggregated:
                # payload counters only exist in windows that saw at least
                # one encoded update (.get keeps restored pre-compression
                # window snapshots loading unchanged)
                self._record_aggregation(
                    now, stats.round_number, merged,
                    payload_bytes=window.get("payload_bytes"),
                    dense_bytes=window.get("dense_bytes"))
            # eval cadence matches the barrier modes: every eval_every
            # rounds' worth of delivered updates, not every window (a
            # FedAsync window is a single update)
            if S["next_eval"] and S["delivered_total"] >= S["next_eval"]:
                stats.accuracy = self._evaluate(S["params"])
                result.accuracy_curve.append((stats.round_number,
                                              stats.accuracy))
                S["next_eval"] += self.eval_every * cohort_size
            result.rounds.append(stats)
            if verbose:
                self._print_progress("merge", stats)
            S["window"] = self._fresh_window(now)

        if S["issued_total"] == 0:
            # fresh run: honor the per-round in-flight cap in async mode
            # too — the cap bounds the standing slot count (a late
            # ticket's replacement can exceed it transiently, as in
            # barrier mode's overlapping rounds)
            slots = cohort_size
            if self.engine.max_concurrency is not None:
                slots = min(slots, self.engine.max_concurrency)
            for cid in propose(slots, clock.now):
                issue(cid, clock.now)

        while S["delivered_total"] < S["target"]:
            if next_ckpt is not None and clock.now >= next_ckpt:
                # event-horizon snapshot: between events, every layer's
                # state is self-consistent (tickets, queue, engine, cost)
                S["snapshots"] += 1
                checkpointer.save(self, S["params"], S["snapshots"])
                next_ckpt = clock.now + checkpoint_every
            ev = self.queue.pop()
            if ev is None:
                break                       # population exhausted
            # refresh the trace alias to the *current* version before the
            # engine records anything for this ticket: attempt records
            # then share the resolution-time version space with billing
            # records (the "ticket" field keeps the issue identity)
            if (self.trace is not None and ev.round_number in tickets):
                self.trace.alias_round(ev.round_number, S["version"])
            if ev.kind is EventKind.ROUND_DEADLINE:
                info = tickets.get(ev.round_number)
                if info is None:
                    continue
                # single-client tickets: `unstarted` cannot occur (the
                # engine cap is per-ticket and each ticket fires one client)
                late, dead, _unstarted = self.engine.close_round(
                    ev.round_number, ev.time)
                for cid in dead:
                    # never produced an observable event: crash profile or
                    # an unobserved timeout kill — the deadline discovers it
                    tickets.pop(ev.round_number, None)
                    in_flight.discard(cid)
                    self.history.mark_miss(cid, info.version)
                    self.cost.charge_straggler(self.round_timeout_s,
                                               client_id=cid,
                                               round_number=S["version"])
                    self.scheduler.notify_miss(cid, ev.time)
                    S["window"]["crashed"].append(cid)
                    refill(ev.time)
                for cid in late:
                    # alive but slow: let it keep running — its update will
                    # merge on arrival, staleness-damped — and refill the
                    # slot so throughput holds
                    info.replaced = True
                    self.history.mark_miss(cid, info.version)
                    self.scheduler.notify_miss(cid, ev.time, crashed=False)
                    S["window"]["late"].append(cid)
                    refill(ev.time)
                continue

            completion = self.engine.handle(self.queue, ev)
            if completion is None:
                continue
            info = tickets.pop(completion.round_number, None)
            if info is None:
                continue                    # cross-mode leftovers
            info.cancel_deadline()
            cid = completion.client_id
            in_flight.discard(cid)
            S["window"]["retries"] += completion.attempts - 1
            # two number spaces, deliberately: charges key on the current
            # model version = the accumulating window's index (so
            # cost_by_round joins RoundStats.round_number), while history
            # keys on the ticket's *issue* version (what the client
            # actually trained against — the staleness base)
            self._bill_attempts(completion, S["version"])

            if not completion.success:
                # paper §VI-C straggler convention, as in barrier mode:
                # a terminal failure is charged for its whole (ticket)
                # window, keeping cross-mode cost comparisons apples-to-
                # apples; the earlier retried attempts were billed above
                self.cost.charge_straggler(self.round_timeout_s,
                                           client_id=cid,
                                           round_number=S["version"])
                self.history.mark_miss(cid, info.version)
                self.scheduler.notify_miss(cid, ev.time)
                S["window"]["crashed"].append(cid)
                if not info.replaced:
                    refill(ev.time)
                continue

            out = completion.outcome
            self.cost.charge(out.duration_s, client_id=cid,
                             round_number=S["version"])
            self._charge_egress(completion.update, cid, S["version"])
            # client-side report corrects the miss a late ticket recorded
            self.history.client_report(cid, info.version, out.duration_s)
            if not info.replaced:
                self.history.mark_success(cid, info.version)
                refill(ev.time)             # issue lands in this window
            else:
                S["window"]["straggler_arrivals"].append(cid)
            # an arrived update clears the client's failure backoff
            self.scheduler.notify_finish(cid, ev.time,
                                         duration_s=out.duration_s,
                                         cold=out.cold,
                                         late=info.replaced)

            S["delivered_total"] += 1
            S["window"]["delivered"].append(cid)
            upd = completion.update
            if upd is not None and upd.payload_bytes is not None:
                # wire-size tally for this window's aggregation record —
                # keys appear only when compression is on, so dense-run
                # windows (and their checkpoints) keep their legacy shape
                w = S["window"]
                w["payload_bytes"] = (w.get("payload_bytes", 0)
                                      + upd.payload_bytes)
                w["dense_bytes"] = (w.get("dense_bytes", 0)
                                    + (upd.dense_bytes or 0))
            new_params = self.strategy.on_client_finish(
                completion.update, arrival_time=ev.time,
                producing_round=info.version, current_round=S["version"],
                global_params=S["params"])
            if new_params is not None:
                S["params"] = new_params
                S["version"] += 1
                close_window(ev.time, self.strategy.last_aggregate_count)

        # abandoned in-flight invocations are still launched work: the
        # provider bills them whether or not we keep listening, so drain
        # and charge them before closing the books (they land in the
        # trailing accounting window)
        for tid, info in sorted(tickets.items()):
            info.cancel_deadline()
            if self.trace is not None:
                self.trace.alias_round(tid, S["version"])
            for cid, billed_s in self.engine.drain_round(tid, clock.now):
                self.cost.charge(billed_s, client_id=cid,
                                 round_number=S["version"],
                                 kind="abandoned")
        tickets.clear()

        # flush partially-buffered strategy state (FedBuff's trailing <K
        # buffer) so every delivered update reaches the final model …
        final = self.strategy.finalize(S["params"],
                                       current_round=S["version"])
        if final is not None:
            S["params"] = final
            S["version"] += 1
            close_window(clock.now, self.strategy.last_aggregate_count)
        elif (S["window"]["delivered"] or S["window"]["crashed"]
                or S["window"]["late"]
                or self.cost.total > S["window"]["cost0"]):
            # … and account the trailing activity (charges, deliveries,
            # crash probes) that landed after the last aggregation event
            close_window(clock.now, 0, aggregated=False)

        result.final_accuracy = self._evaluate(S["params"])
        result.cost_by_client = dict(self.cost.by_client)
        result.cost_by_round = dict(self.cost.rounds)
        self._async_live = None
        return S["params"], result

    def _fresh_window(self, now: float) -> Dict[str, Any]:
        return {"start": now, "issued": [], "delivered": [], "late": [],
                "crashed": [], "straggler_arrivals": [], "retries": 0,
                "cost0": self.cost.total}

    # ------------------------------------------------------------------
    # checkpoint surface (fl/checkpointing.py)
    # ------------------------------------------------------------------
    def checkpoint_state(self, arrays: Optional[Dict[str, Any]] = None
                         ) -> dict:
        """Full-fidelity snapshot of the driver's mutable state.

        Beyond the round-boundary state (history, every RNG stream,
        scheduler state, cost tallies, virtual clock, trailing RoundStats
        telemetry), the snapshot captures the *pending timeline*: every
        live event in the queue with its seq counter, the engine's
        in-flight invocations (plans, retry counters, cached updates),
        warm-instance pools (single platform or the whole fleet), rolling
        routing telemetry, and the semi-async/FedBuff update buffers.  A
        restored run therefore replays the remaining events byte-
        identically to an uninterrupted same-seed run — in-flight
        stragglers included — which is also what makes the barrier-free
        mode checkpointable: `_run_async` exposes its loop state here and
        snapshots at event horizons instead of round boundaries.

        Pytree-valued state (per-round global params, cached client
        updates, pending/buffered updates) is deposited into `arrays`;
        the checkpointer saves it alongside the global params.
        """
        arrays = {} if arrays is None else arrays
        state = {
            "mode": self.mode,
            "strategy": self.strategy.name,
            "scheduler_name": self.scheduler.name,
            "clock": self.queue.clock.now,
            "history": self.history.to_payload(),
            "driver_rng": self.rng.bit_generator.state,
            "strategy_state": self.strategy.state_dict(arrays),
            "scheduler": self.scheduler.state_dict(),
            "cost": self.cost.state_dict(),
            "recent_stats": [asdict(r) for r in self._recent_stats],
            "queue": self.queue.state_dict(),
            "engine": self.engine.state_dict(arrays),
            "next_ticket": self._next_ticket,
        }
        compressor = getattr(self.pool, "compressor", None)
        if compressor is not None and compressor.config.active:
            # client-side error-feedback residuals ride the checkpoint's
            # array store like server-opt moments; dense runs add nothing
            state["compressor"] = compressor.state_dict(arrays)
        fleet = getattr(self.invoker, "fleet", None)
        if fleet is not None:
            # multi-provider runs: every platform's RNG/warm pool plus
            # the routing decisions, not just the default platform
            state["fleet"] = fleet.state_dict()
        elif hasattr(self.platform, "state_dict"):
            state["platform"] = self.platform.state_dict()
        if self.trace is not None:
            state["telemetry"] = self.trace.telemetry_state_dict()
            state["trace_offset"] = getattr(self.trace, "record_count",
                                            len(self.trace.records))
        if self.mode == "async":
            state["async"] = self._async_checkpoint_state()
        return state

    def _async_checkpoint_state(self) -> dict:
        """Snapshot `_run_async`'s live loop state (event-horizon path)."""
        S = self._async_live
        if S is None:
            raise RuntimeError(
                "async checkpoints are event-horizon snapshots taken "
                "inside a running _run_async loop (checkpoint_every "
                "virtual seconds); there is no driver-idle state to save")
        result: ExperimentResult = S["result"]
        return {
            "target": S["target"], "version": S["version"],
            "delivered_total": S["delivered_total"],
            "next_eval": S["next_eval"],
            "issue_budget": S["issue_budget"],
            "issued_total": S["issued_total"],
            "snapshots": S["snapshots"],
            "in_flight": sorted(S["in_flight"]),
            "tickets": {str(tid): {
                "client_id": t.client_id, "version": t.version,
                "replaced": t.replaced,
                "deadline_seq": (None if t.deadline is None
                                 or t.deadline.cancelled
                                 else t.deadline.seq)}
                for tid, t in S["tickets"].items()},
            "window": S["window"],
            "rounds": [asdict(r) for r in result.rounds],
            "accuracy_curve": [list(t) for t in result.accuracy_curve],
        }

    def restore_state(self, state: dict,
                      arrays: Optional[Dict[str, Any]] = None) -> None:
        """Inverse of `checkpoint_state` (same driver wiring assumed)."""
        arrays = {} if arrays is None else arrays
        self.queue.clock.advance_to(float(state["clock"]))
        events_by_seq = self.queue.load_state_dict(state.get("queue", {}))
        self.engine.load_state_dict(state.get("engine", {}), events_by_seq,
                                    arrays)
        self.history.load_payload(state["history"])
        self.rng.bit_generator.state = state["driver_rng"]
        if "strategy_state" in state:
            self.strategy.load_state_dict(state["strategy_state"], arrays)
        elif "strategy_rng" in state:     # schema-v1 checkpoints
            self.strategy.rng.bit_generator.state = state["strategy_rng"]
        self.scheduler.load_state_dict(state.get("scheduler", {}))
        self.cost.load_state_dict(state.get("cost", {}))
        self._recent_stats = [RoundStats(**d)
                              for d in state.get("recent_stats", [])]
        self._next_ticket = int(state.get("next_ticket", self._next_ticket))
        if "compressor" in state:
            compressor = getattr(self.pool, "compressor", None)
            if compressor is not None:
                compressor.load_state_dict(state["compressor"], arrays)
        fleet = getattr(self.invoker, "fleet", None)
        if "fleet" in state and fleet is not None:
            fleet.load_state_dict(state["fleet"])
        elif "platform" in state and hasattr(self.platform,
                                             "load_state_dict"):
            self.platform.load_state_dict(state["platform"])
        if "telemetry" in state and self.trace is not None:
            self.trace.load_telemetry_state(state["telemetry"])
        if "async" in state:
            self._async_resume = self._rebuild_async(state["async"],
                                                     events_by_seq)

    def _rebuild_async(self, a: dict, events_by_seq: dict) -> dict:
        """Rebuild `_run_async`'s loop state from its snapshot, re-linking
        ticket deadlines to the restored queue's event objects (a ticket
        whose deadline already fired — late-but-alive — gets None)."""
        result = ExperimentResult(strategy=self.strategy.name,
                                  mode=self.mode)
        result.rounds = [RoundStats(**d) for d in a.get("rounds", [])]
        result.accuracy_curve = [tuple(t)
                                 for t in a.get("accuracy_curve", [])]
        tickets: Dict[int, _AsyncTicket] = {}
        for tid, t in a.get("tickets", {}).items():
            seq = t.get("deadline_seq")
            ticket = _AsyncTicket(t["client_id"], int(t["version"]),
                                  events_by_seq.get(seq)
                                  if seq is not None else None)
            ticket.replaced = bool(t.get("replaced", False))
            tickets[int(tid)] = ticket
        window = dict(a.get("window", {}))
        return {
            "target": int(a["target"]), "version": int(a["version"]),
            "delivered_total": int(a["delivered_total"]),
            "next_eval": a.get("next_eval", 0),
            "issue_budget": int(a["issue_budget"]),
            "issued_total": int(a["issued_total"]),
            "snapshots": int(a.get("snapshots", 0)),
            "tickets": tickets,
            "in_flight": set(a.get("in_flight", [])),
            "window": window,
            "result": result,
        }

    # ------------------------------------------------------------------
    def run(self, global_params: Pytree, n_rounds: int,
            verbose: bool = False, start_round: int = 0,
            checkpointer=None, checkpoint_every: float = 0) -> tuple:
        if self.mode == "async":
            if start_round:
                raise ValueError(
                    "start_round is a barrier-mode concept; async resume "
                    "restores mid-timeline state via "
                    "RoundCheckpointer.restore")
            # async cadence: checkpoint_every is in *virtual seconds*
            return self._run_async(global_params, n_rounds, verbose=verbose,
                                   checkpointer=checkpointer,
                                   checkpoint_every=float(checkpoint_every
                                                          or 0.0))
        result = ExperimentResult(strategy=self.strategy.name, mode=self.mode)
        params = global_params
        ck_every = int(checkpoint_every or 0)
        if ck_every != (checkpoint_every or 0):
            raise ValueError(
                f"checkpoint_every={checkpoint_every!r} must be a whole "
                f"number of rounds in barrier modes (virtual seconds are "
                f"an async-mode unit)")
        for rnd in range(start_round, n_rounds):
            params, stats = self.run_round(params, rnd)
            if self.eval_every and (rnd + 1) % self.eval_every == 0:
                stats.accuracy = self._evaluate(params)
                result.accuracy_curve.append((rnd, stats.accuracy))
            result.rounds.append(stats)
            if verbose:
                self._print_progress("round", stats)
            if (checkpointer is not None and ck_every
                    and (rnd + 1) % ck_every == 0):
                checkpointer.save(self, params, rnd + 1)
        result.final_accuracy = self._evaluate(params)
        result.cost_by_client = dict(self.cost.by_client)
        result.cost_by_round = dict(self.cost.rounds)
        return params, result


# Back-compat: the pre-refactor name; every call site keeps working.
Controller = TrainingDriver
