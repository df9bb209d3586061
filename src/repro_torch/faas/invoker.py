"""Invoker — bridges the FL controller and the (simulated) FaaS platform.

This is the paper's *Mock Invoker* (§IV-A): it lets the entire system run
on one machine by simulating the behaviour of the deployed client
functions, while executing the clients' actual training code so that the
produced model updates are real.  The controller code path is identical to
what a live-HTTP invoker would use.

Two layers live here:

  * `MockInvoker` — the per-client work + platform routing surface
    (single platform; `faas.profiles.MultiPlatformInvoker` is the fleet
    twin).  Its legacy `invoke_clients` batch API is kept for direct
    tests and external callers.
  * `InvocationEngine` — the event-driven scheduler the controller now
    drives.  It turns each invocation into lifecycle events on the
    shared `EventQueue`, enforces a per-round concurrency cap, and
    re-invokes transiently failed clients up to `max_retries` times (the
    FedLess invoker's retry behaviour) — every attempt billed.
"""
from __future__ import annotations

from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.aggregation import (ClientUpdate, update_from_record,
                                update_to_record)
from .events import Event, EventKind, EventQueue
from .platform import (FAIL_PLATFORM, FAIL_TIMEOUT, ClientProfile,
                       InvocationOutcome, InvocationPlan,
                       SimulatedFaaSPlatform)

Pytree = Any

# Client work callback: (client_id, global_params, round) ->
#   (ClientUpdate, nominal_work_seconds)
ClientWorkFn = Callable[[str, Pytree, int], tuple]


@dataclass
class InvocationResult:
    outcome: InvocationOutcome
    update: Optional[ClientUpdate]  # None when the invocation crashed


@dataclass
class ClientCompletion:
    """Terminal result of one logical invocation (all attempts included)."""
    round_number: int
    client_id: str
    outcome: InvocationOutcome
    update: Optional[ClientUpdate]          # None when terminally failed
    attempts: int = 1
    failed_attempts: List[InvocationOutcome] = field(default_factory=list)

    @property
    def success(self) -> bool:
        return not self.outcome.crashed


class MockInvoker:
    """Invokes client functions against the simulated platform.

    `profiles` carries the experiment scenario's straggler injection
    (slow factors / crashes) keyed by client id.
    """

    def __init__(self, platform: SimulatedFaaSPlatform,
                 work_fn: ClientWorkFn,
                 profiles: Optional[Dict[str, ClientProfile]] = None):
        self.platform = platform
        self.work_fn = work_fn
        self.profiles = profiles or {}

    def platform_of(self, client_id: str) -> SimulatedFaaSPlatform:
        return self.platform

    def invoke_clients(self, client_ids: Sequence[str], global_params: Pytree,
                       round_number: int,
                       start_time: float) -> List[InvocationResult]:
        results = []
        for cid in client_ids:
            profile = self.profiles.get(cid, ClientProfile())
            if profile.crash:
                outcome = self.platform.invoke(cid, 0.0, start_time, profile)
                results.append(InvocationResult(outcome=outcome, update=None))
                continue
            update, nominal_s = self.work_fn(cid, global_params, round_number)
            outcome = self.platform.invoke(cid, nominal_s, start_time, profile)
            results.append(InvocationResult(
                outcome=outcome, update=None if outcome.crashed else update))
        return results


# ======================================================================
class _RoundState:
    """Per-round scheduling state inside the engine."""

    def __init__(self, round_number: int, client_ids: Sequence[str],
                 global_params: Pytree):
        self.round_number = round_number
        self.client_ids = list(client_ids)
        self.global_params = global_params
        self.waiting: deque = deque()            # cap overflow, not yet fired
        self.active = 0                          # invocations in flight
        self.platform_names: Dict[str, str] = {} # routing decision at start
        self.attempts: Dict[str, int] = {}
        self.failed: Dict[str, List[InvocationOutcome]] = {}
        # cid -> (plan, update, [scheduled events])
        self.inflight: Dict[str, Tuple[InvocationPlan,
                                       Optional[ClientUpdate], list]] = {}
        self.work: Dict[str, tuple] = {}         # cid -> (update, nominal_s)
        # deferred batch work: a thunk producing work-cache entries, run
        # when the round's first INVOKE_START fires (not at open_round) —
        # the overlapped-dispatch hook.  Never checkpointed: open_round
        # and the first event land in the same controller turn.
        self.work_provider: Optional[Callable[[], Optional[Dict[str, tuple]]]] = None
        self.retrying: set = set()               # retry fired, not restarted
        self.done: set = set()
        self.closed = False


class InvocationEngine:
    """Event-driven invocation scheduler over any invoker that exposes
    `platform_of(cid)`, `work_fn` and `profiles`.

    The engine owns the invocation lifecycle; the controller owns round
    semantics (deadline, history, cost, aggregation) and consumes the
    `ClientCompletion`s the engine emits from `handle()`.
    """

    def __init__(self, invoker, max_retries: int = 1,
                 max_concurrency: Optional[int] = None,
                 retry_on_timeout: bool = False, recorder=None):
        self.invoker = invoker
        self.max_retries = max_retries
        self.max_concurrency = max_concurrency
        self.retry_on_timeout = retry_on_timeout
        # optional TraceRecorder (faas/trace.py): one record per resolved
        # invocation attempt, carrying the routing decision (platform name)
        self.recorder = recorder
        self._rounds: Dict[int, _RoundState] = {}

    def _record_attempt(self, st: _RoundState, cid: str,
                        plan: InvocationPlan, attempt: int,
                        arrival_time: float, status: str) -> None:
        if self.recorder is None:
            return
        outcome = plan.to_outcome()
        # compressed runs stamp the attempt with its simulated wire size;
        # dense updates keep payload None and the record's key set stays
        # exactly the legacy one (byte-parity with pre-compression traces)
        cached = st.work.get(cid)
        payload = (cached[0].payload_bytes
                   if cached is not None and cached[0] is not None else None)
        # dispatch_s is wall-clock launch telemetry stamped by the
        # executor when timing collection is on — like payload_bytes it
        # is only-when-set, so dense/default traces stay byte-identical
        dispatch = (cached[0].dispatch_s
                    if cached is not None and cached[0] is not None else None)
        # the platform captured at _start time: platform_of() may be a
        # *mutating* routing call (TelemetryRoutingPolicy can re-route),
        # so it must not be re-resolved as a side effect of logging
        self.recorder.attempt(
            client_id=cid, platform=st.platform_names.get(cid, "?"),
            round_number=st.round_number, attempt=attempt,
            start_time=plan.start_time, arrival_time=arrival_time,
            cold=plan.cold, cold_start_s=plan.cold_start_s,
            billed_s=outcome.duration_s, status=status,
            payload_bytes=payload, dispatch_s=dispatch)

    # ------------------------------------------------------------------
    def open_round(self, queue: EventQueue, client_ids: Sequence[str],
                   global_params: Pytree, round_number: int,
                   start_time: float,
                   precomputed: Optional[Dict[str, tuple]] = None,
                   work_provider: Optional[
                       Callable[[], Optional[Dict[str, tuple]]]] = None
                   ) -> None:
        """Schedule the round's invocations; at most `max_concurrency` are
        in flight at once, the rest start as earlier ones resolve.

        ``precomputed`` seeds the work cache eagerly; ``work_provider``
        defers the same batch to the round's first INVOKE_START — with
        overlapped dispatch the provider *launches* the executor's async
        group dispatch and returns unready handles, so the rest of the
        round's event bookkeeping runs while the devices train.  Both
        fire at the same virtual time with identical client order, so
        the two paths are trace-byte-identical."""
        st = _RoundState(round_number, client_ids, global_params)
        if precomputed:
            st.work.update(precomputed)
        st.work_provider = work_provider
        self._rounds[round_number] = st
        cap = self.max_concurrency or len(st.client_ids)
        for cid in st.client_ids[:cap]:
            self._fire(queue, st, cid, start_time)
        st.waiting.extend(st.client_ids[cap:])

    def _fire(self, queue: EventQueue, st: _RoundState, cid: str,
              when: float) -> None:
        st.active += 1
        queue.schedule(when, EventKind.INVOKE_START, client_id=cid,
                       round_number=st.round_number)

    # ------------------------------------------------------------------
    def handle(self, queue: EventQueue,
               event: Event) -> Optional[ClientCompletion]:
        """Process one event; returns a ClientCompletion when an
        invocation reached a terminal state (success or retries
        exhausted), else None."""
        kind = event.kind
        if kind is EventKind.INVOKE_START:
            self._start(queue, event)
        elif kind is EventKind.CLIENT_FINISH:
            return self._finish(queue, event)
        elif kind is EventKind.PLATFORM_FAILURE:
            return self._failure(queue, event)
        elif kind is EventKind.WARM_EXPIRY:
            # events carry the platform *name* (payloads must stay
            # serializable for the checkpoint snapshot); resolve it
            # against the invoker's platform registry here
            platform = self._platform_named(event.data.get("platform"))
            if platform is not None:
                platform.expire_warm(event.client_id, event.time)
        # COLD_START_DONE / ROUND_DEADLINE: telemetry / controller-owned
        return None

    # ------------------------------------------------------------------
    def _start(self, queue: EventQueue, event: Event) -> None:
        st = self._rounds.get(event.round_number)
        if st is None or st.closed:
            return      # round closed between scheduling and firing
        cid = event.client_id
        if st.work_provider is not None:
            # consume exactly once, before any per-client work_fn can run
            provider, st.work_provider = st.work_provider, None
            produced = provider()
            if produced:
                st.work.update(produced)
        st.retrying.discard(cid)
        profile = self.invoker.profiles.get(cid, ClientProfile())
        platform = self.invoker.platform_of(cid)
        st.platform_names[cid] = platform.name

        if profile.crash:
            update, nominal_s = None, 0.0
        elif cid in st.work:
            update, nominal_s = st.work[cid]
        else:
            update, nominal_s = self.invoker.work_fn(
                cid, st.global_params, st.round_number)
            st.work[cid] = (update, nominal_s)

        # compressed updates carry their simulated wire size — the upload
        # rides inside the invocation window, so the platform's timeout /
        # speed-scaling / billing math all see the transfer term (dense
        # updates have payload_bytes None: zero-size legacy behaviour)
        work_s = nominal_s
        if update is not None and update.payload_bytes is not None:
            bw = platform.config.upload_bandwidth_bps
            if bw > 0:
                work_s = nominal_s + update.payload_bytes / bw

        attempt = st.attempts.get(cid, 0)
        plan = platform.plan_invocation(cid, work_s, event.time, profile,
                                        attempt=attempt)
        scheduled: list = []
        if plan.cold and plan.cold_start_s > 0:
            scheduled.append(queue.schedule(
                event.time + plan.cold_start_s, EventKind.COLD_START_DONE,
                client_id=cid, round_number=st.round_number,
                platform=platform.name))
        if plan.failure is None:
            scheduled.append(queue.schedule(
                plan.finish_time, EventKind.CLIENT_FINISH, client_id=cid,
                round_number=st.round_number))
            queue.schedule(plan.warm_until, EventKind.WARM_EXPIRY,
                           client_id=cid, platform=platform.name)
        elif plan.fail_time != float("inf"):
            scheduled.append(queue.schedule(
                plan.fail_time, EventKind.PLATFORM_FAILURE, client_id=cid,
                round_number=st.round_number, reason=plan.failure))
        # FAIL_CRASH: no event — discovered at the round deadline
        st.inflight[cid] = (plan, update, scheduled)

    # ------------------------------------------------------------------
    def _finish(self, queue: EventQueue,
                event: Event) -> Optional[ClientCompletion]:
        st = self._rounds.get(event.round_number)
        if st is None or event.client_id not in st.inflight:
            return None     # resolved at a round close; stale event
        cid = event.client_id
        plan, update, _ = st.inflight.pop(cid)
        st.done.add(cid)
        self._release_slot(queue, st, event.time)
        self._record_attempt(st, cid, plan, st.attempts.get(cid, 0),
                             event.time, "ok")
        completion = ClientCompletion(
            round_number=st.round_number, client_id=cid,
            outcome=plan.to_outcome(), update=update,
            attempts=st.attempts.get(cid, 0) + 1,
            failed_attempts=st.failed.get(cid, []))
        self._maybe_gc(st)
        return completion

    def _failure(self, queue: EventQueue,
                 event: Event) -> Optional[ClientCompletion]:
        st = self._rounds.get(event.round_number)
        if st is None or event.client_id not in st.inflight:
            return None
        cid = event.client_id
        plan, update, _ = st.inflight.pop(cid)
        outcome = plan.to_outcome()
        st.failed.setdefault(cid, []).append(outcome)
        attempt = st.attempts.get(cid, 0)
        self._record_attempt(st, cid, plan, attempt, event.time,
                             plan.failure or "failed")

        retryable = (plan.failure == FAIL_PLATFORM
                     or (plan.failure == FAIL_TIMEOUT
                         and self.retry_on_timeout))
        if retryable and attempt < self.max_retries and not st.closed:
            # FedLess invoker behaviour: immediately re-invoke (same slot,
            # attempt counter bumped; every attempt is billed separately).
            st.attempts[cid] = attempt + 1
            st.retrying.add(cid)
            queue.schedule(event.time, EventKind.INVOKE_START, client_id=cid,
                           round_number=st.round_number)
            return None

        st.done.add(cid)
        self._release_slot(queue, st, event.time)
        completion = ClientCompletion(
            round_number=st.round_number, client_id=cid, outcome=outcome,
            update=None, attempts=attempt + 1,
            failed_attempts=st.failed.get(cid, [])[:-1])
        self._maybe_gc(st)
        return completion

    def _release_slot(self, queue: EventQueue, st: _RoundState,
                      now: float) -> None:
        st.active -= 1
        if st.waiting and not st.closed:
            self._fire(queue, st, st.waiting.popleft(), now)

    # ------------------------------------------------------------------
    def close_round(self, round_number: int,
                    now: float) -> Tuple[List[str], List[str], List[str]]:
        """Round deadline bookkeeping.  Returns

            (late, dead, unstarted)

        * late      — in flight with a live CLIENT_FINISH in the future:
                      the client is alive, its update will arrive
                      mid-flight during a later round;
        * dead      — in flight with no pending finish (crash profiles,
                      not-yet-observed timeout kills): cancelled;
        * unstarted — never fired because of the concurrency cap.
        """
        st = self._rounds.get(round_number)
        if st is None:
            return [], [], []
        st.closed = True
        late, dead = [], []
        for cid, (plan, _upd, scheduled) in list(st.inflight.items()):
            if plan.failure is None and plan.finish_time > now:
                late.append(cid)
                continue
            dead.append(cid)
            for ev in scheduled:
                ev.cancel()
            del st.inflight[cid]
            st.done.add(cid)
            # crash plans never surface as events — the deadline is the
            # first (and only) observation, so record the attempt here
            self._record_attempt(st, cid, plan, st.attempts.get(cid, 0),
                                 now, plan.failure or "unresponsive")
        # a retry whose INVOKE_START is still queued at close never runs
        # (the start handler drops it): the client missed the round
        dead.extend(sorted(st.retrying))
        st.done.update(st.retrying)
        st.retrying.clear()
        unstarted = list(st.waiting)
        st.waiting.clear()
        st.done.update(unstarted)
        self._maybe_gc(st)
        return late, dead, unstarted

    def drain_round(self, round_number: int,
                    now: float) -> List[Tuple[str, float]]:
        """Abandon an open round at experiment end: cancel its scheduled
        events and return (client_id, billable_s) for every in-flight
        attempt — the provider bills a launched invocation regardless of
        whether the controller is still listening for its result."""
        st = self._rounds.get(round_number)
        if st is None:
            return []
        st.closed = True
        billed = []
        for cid, (plan, _upd, scheduled) in list(st.inflight.items()):
            for ev in scheduled:
                ev.cancel()
            self._record_attempt(st, cid, plan, st.attempts.get(cid, 0),
                                 now, "abandoned")
            billed.append((cid, plan.to_outcome().duration_s))
            del st.inflight[cid]
            st.done.add(cid)
        st.retrying.clear()
        st.waiting.clear()
        self._maybe_gc(st)
        return billed

    def unresolved_count(self, round_number: int) -> int:
        """Clients of the round that could still produce an event: in
        flight, waiting on a slot, or mid-retry.  Crash-profile clients
        count — the controller cannot observe that they never respond."""
        st = self._rounds.get(round_number)
        if st is None:
            return 0
        return len(st.inflight) + len(st.waiting) + len(st.retrying)

    def _maybe_gc(self, st: _RoundState) -> None:
        if st.closed and not st.inflight and not st.waiting:
            self._rounds.pop(st.round_number, None)

    # ------------------------------------------------------------------
    # checkpoint surface (fl/checkpointing.py)
    # ------------------------------------------------------------------
    def _platform_named(self, name) -> Optional[SimulatedFaaSPlatform]:
        """Resolve a platform by name against the invoker (single-platform
        MockInvoker or a MultiPlatformInvoker's fleet).  Unknown names
        resolve to None — expiring a *different* platform's warm pool
        would be worse than ignoring a stale event."""
        platforms = getattr(self.invoker, "platforms", None)
        if platforms is not None:
            return platforms.get(name)
        platform = getattr(self.invoker, "platform", None)
        if platform is not None and (name is None or platform.name == name):
            return platform
        return None

    def state_dict(self, arrays: Dict[str, Any]) -> dict:
        """JSON-ready snapshot of every open round's scheduling state.

        Scalars (plans, attempts, failed outcomes, waiting/retrying/done
        sets) go into the returned record; pytrees — the round's global
        params and each cached `ClientUpdate` — are deposited into
        `arrays` under ``engine/...`` keys and saved alongside the
        checkpoint params (they share the model's tree structure).
        In-flight updates are not stored twice: an inflight entry's
        update *is* its work-cache entry, so only the cache is saved and
        `load_state_dict` re-links the reference.  Global-params trees
        are deduplicated by object identity: the async driver opens one
        engine round per in-flight ticket, all sharing the same model
        object, which would otherwise put N full model copies in every
        snapshot.
        """
        rounds = []
        params_slots: Dict[int, str] = {}    # id(tree) -> arrays key
        for rnd, st in sorted(self._rounds.items()):
            params_key = params_slots.get(id(st.global_params))
            if params_key is None:
                params_key = f"engine/params/{len(params_slots)}"
                params_slots[id(st.global_params)] = params_key
                arrays[params_key] = st.global_params
            work = {}
            for cid, (update, nominal_s) in st.work.items():
                entry = {"nominal_s": nominal_s, "update": None}
                if update is not None:
                    # .params is the device-pipeline lazy-materialization
                    # point: a batch-backed update (DeviceUpdateBatch row)
                    # builds its concrete pytree here, exactly when the
                    # in-flight snapshot genuinely needs tree structure
                    arrays[f"engine/{rnd}/work/{cid}"] = update.params
                    entry["update"] = update_to_record(update)
                work[cid] = entry
            rounds.append({
                "round": rnd,
                "params_key": params_key,
                "client_ids": list(st.client_ids),
                "waiting": list(st.waiting),
                "active": st.active,
                "platform_names": dict(st.platform_names),
                "attempts": dict(st.attempts),
                "failed": {cid: [asdict(o) for o in outs]
                           for cid, outs in st.failed.items()},
                "inflight": {cid: {"plan": asdict(plan),
                                   "has_update": update is not None,
                                   "scheduled": [ev.seq for ev in scheduled
                                                 if not ev.cancelled]}
                             for cid, (plan, update, scheduled)
                             in st.inflight.items()},
                "work": work,
                "retrying": sorted(st.retrying),
                "done": sorted(st.done),
                "closed": st.closed,
            })
        return {"rounds": rounds}

    def load_state_dict(self, state: dict, events_by_seq: Dict[int, Event],
                        arrays: Dict[str, Any]) -> None:
        """Inverse of `state_dict`: rebuild the open rounds and re-link
        their scheduled-event handles to the restored queue's events."""
        self._rounds = {}
        for rec in state.get("rounds", []):
            rnd = rec["round"]
            st = _RoundState(rnd, rec["client_ids"],
                             arrays.get(rec.get("params_key")))
            st.waiting = deque(rec.get("waiting", []))
            st.active = int(rec.get("active", 0))
            st.platform_names = dict(rec.get("platform_names", {}))
            st.attempts = {cid: int(n)
                           for cid, n in rec.get("attempts", {}).items()}
            st.failed = {cid: [InvocationOutcome(**o) for o in outs]
                         for cid, outs in rec.get("failed", {}).items()}
            for cid, w in rec.get("work", {}).items():
                update = None
                if w.get("update") is not None:
                    update = update_from_record(
                        w["update"], arrays[f"engine/{rnd}/work/{cid}"])
                st.work[cid] = (update, float(w["nominal_s"]))
            for cid, inf in rec.get("inflight", {}).items():
                update = (st.work[cid][0] if inf.get("has_update")
                          else None)
                scheduled = [events_by_seq[seq]
                             for seq in inf.get("scheduled", [])
                             if seq in events_by_seq]
                st.inflight[cid] = (InvocationPlan(**inf["plan"]), update,
                                    scheduled)
            st.retrying = set(rec.get("retrying", []))
            st.done = set(rec.get("done", []))
            st.closed = bool(rec.get("closed", False))
            self._rounds[rnd] = st
