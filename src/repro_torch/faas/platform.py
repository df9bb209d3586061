"""Simulated FaaS platform with a virtual clock.

Models the serverless characteristics the paper identifies as the reason
stragglers behave differently in FaaS (§II, §III-C):

  * cold starts — a function instance that is not warm pays a sampled
    cold-start latency before useful work begins;
  * scale-to-zero — warm instances expire after an idle timeout;
  * performance variation — each fresh instance lands on an unknown VM and
    gets a sampled speed factor (Wang et al. [29]);
  * weak reliability — invocations fail with (1 − SLO) probability
    (GCF SLO: 99.95% uptime);
  * function timeout — invocations are killed at the platform limit.

Everything runs on a virtual clock.  The platform does not sleep or
block: `plan_invocation()` samples the full timing of one invocation
(cold start, landed-instance speed, jitter, failure mode) and returns an
`InvocationPlan` the event engine turns into INVOKE_START /
COLD_START_DONE / CLIENT_FINISH / PLATFORM_FAILURE / WARM_EXPIRY events,
so a full FL experiment with hundreds of clients simulates in
milliseconds while preserving the timing structure the scheduling
strategy reacts to.  `invoke()` remains as the one-shot convenience
wrapper (plan + outcome in one call) for direct platform tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .cost import FunctionShape


@dataclass(frozen=True)
class FaaSConfig:
    cold_start_median_s: float = 3.0     # GCF gen-2 cold start, median
    cold_start_sigma: float = 0.5        # lognormal spread
    warm_idle_timeout_s: float = 900.0   # scale-to-zero after 15 min idle
    perf_variation: tuple = (0.85, 1.35) # per-instance speed multiplier
    failure_rate: float = 0.0005         # 1 − SLO(99.95%)
    network_jitter_s: float = 0.5        # invocation + result upload jitter
    function_timeout_s: float = 540.0    # platform kill limit (paper config)
    # client→server update-upload bandwidth; only consulted when an update
    # carries a simulated wire size (compression on), so dense runs never
    # see a transfer term and stay byte-identical
    upload_bandwidth_bps: float = 16e6   # ~16 MB/s function egress


@dataclass
class WarmInstance:
    speed_factor: float
    warm_until: float


@dataclass
class InvocationOutcome:
    client_id: str
    start_time: float
    cold_start_s: float
    compute_s: float            # scaled work time on the landed instance
    crashed: bool               # platform-level failure or timeout kill
    finish_time: float          # = start + cold + compute + jitter (inf if crashed)
    cold: bool
    function_timeout_s: float = float("inf")

    @property
    def duration_s(self) -> float:
        """Billable duration.  The platform kills the instance at
        `function_timeout_s`, so a timeout-killed invocation can never be
        billed past it — the billable window is clamped to the kill."""
        if self.crashed:
            return min(self.cold_start_s + self.compute_s,
                       self.function_timeout_s)
        return self.finish_time - self.start_time


# failure taxonomy used by InvocationPlan.failure
FAIL_CRASH = "crash"        # client never responds (paper's failure straggler)
FAIL_PLATFORM = "platform"  # transient invocation error (1 − SLO) — retryable
FAIL_TIMEOUT = "timeout"    # killed at function_timeout_s


@dataclass
class InvocationPlan:
    """Sampled timing of one invocation attempt, before it 'happens'.

    The event engine consumes this: a plan with `failure is None` yields
    CLIENT_FINISH at `finish_time` (+ a WARM_EXPIRY lease), a retryable
    failure yields PLATFORM_FAILURE at `fail_time`, and a crash yields no
    event at all — the client is only discovered dead at the round
    deadline, exactly like a real non-responding function.
    """
    client_id: str
    start_time: float
    cold_start_s: float
    compute_s: float
    jitter_s: float
    cold: bool
    speed_factor: float
    failure: Optional[str]           # None | FAIL_CRASH/PLATFORM/TIMEOUT
    function_timeout_s: float
    warm_until: float                # 0.0 when the attempt failed

    @property
    def finish_time(self) -> float:
        if self.failure is not None:
            return float("inf")
        return (self.start_time + self.cold_start_s + self.compute_s
                + self.jitter_s)

    @property
    def fail_time(self) -> float:
        """Virtual time the failure becomes observable to the invoker.

        A platform error surfaces when the (doomed) invocation returns; a
        timeout kill at exactly `function_timeout_s`; a crashed client
        never reports (inf — the round deadline discovers it).
        """
        if self.failure == FAIL_PLATFORM:
            return (self.start_time + self.cold_start_s + self.compute_s
                    + self.jitter_s)
        if self.failure == FAIL_TIMEOUT:
            return self.start_time + self.function_timeout_s
        return float("inf")

    def to_outcome(self) -> InvocationOutcome:
        return InvocationOutcome(
            client_id=self.client_id, start_time=self.start_time,
            cold_start_s=self.cold_start_s,
            compute_s=0.0 if self.failure == FAIL_CRASH else self.compute_s,
            crashed=self.failure is not None,
            finish_time=self.finish_time, cold=self.cold,
            function_timeout_s=self.function_timeout_s)


@dataclass
class ClientProfile:
    """Per-client behaviour injected by the experiment scenario.

    `slow_factor` > 1 models resource heterogeneity (weak VM / big data);
    `crash` models the paper's failure-type stragglers (never respond);
    `fail_attempts` injects N deterministic transient platform failures
    before the first successful attempt (exercises the retry path).
    """
    slow_factor: float = 1.0
    crash: bool = False
    fail_attempts: int = 0


class VirtualClock:
    def __init__(self):
        self.now = 0.0

    def advance_to(self, t: float) -> None:
        self.now = max(self.now, t)


class SimulatedFaaSPlatform:
    """One deployment target for client functions (e.g. 'GCF gen2')."""

    def __init__(self, config: Optional[FaaSConfig] = None,
                 shape: Optional[FunctionShape] = None, seed: int = 0,
                 name: str = "sim", recorder=None):
        self.config = config if config is not None else FaaSConfig()
        self.shape = shape if shape is not None else FunctionShape()
        self.name = name
        self.rng = np.random.default_rng(seed)
        self._warm: Dict[str, WarmInstance] = {}
        self.clock = VirtualClock()
        self.cold_starts = 0
        self.invocations = 0
        # optional TraceRecorder (faas/trace.py): every sampled plan feeds
        # the per-platform cold-start/failure telemetry window — including
        # crash plans that never surface as events
        self.recorder = recorder

    # ------------------------------------------------------------------
    def _cold_start_latency(self) -> float:
        c = self.config
        return float(self.rng.lognormal(np.log(c.cold_start_median_s),
                                        c.cold_start_sigma))

    def _instance(self, client_id: str, now: float) -> tuple:
        """Return (speed_factor, cold_start_s, was_cold) for this invocation,
        respecting the warm pool / scale-to-zero."""
        inst = self._warm.get(client_id)
        if inst is not None and inst.warm_until >= now:
            return inst.speed_factor, 0.0, False
        lo, hi = self.config.perf_variation
        speed = float(self.rng.uniform(lo, hi))
        self.cold_starts += 1
        return speed, self._cold_start_latency(), True

    # ------------------------------------------------------------------
    def plan_invocation(self, client_id: str, nominal_work_s: float,
                        start_time: float,
                        profile: Optional[ClientProfile] = None,
                        attempt: int = 0) -> InvocationPlan:
        """Sample one invocation attempt starting at `start_time`.

        `nominal_work_s` is the client's ideal training time (data size ×
        epochs × per-sample cost); the platform scales it by the landed
        instance's speed factor and the client's heterogeneity profile.
        `attempt` counts retries of the same logical invocation.
        """
        profile = profile or ClientProfile()
        self.invocations += 1
        speed, cold_s, was_cold = self._instance(client_id, start_time)

        compute = nominal_work_s * speed * profile.slow_factor
        jitter = float(abs(self.rng.normal(0.0, self.config.network_jitter_s)))
        total = cold_s + compute + jitter

        if profile.crash:
            failure: Optional[str] = FAIL_CRASH
        else:
            transient = (attempt < profile.fail_attempts
                         or self.rng.random() < self.config.failure_rate)
            if transient:
                failure = FAIL_PLATFORM
            elif total > self.config.function_timeout_s:
                failure = FAIL_TIMEOUT
            else:
                failure = None

        warm_until = 0.0
        if failure is None:
            # keep/refresh the warm instance lease
            finish = start_time + total
            warm_until = finish + self.config.warm_idle_timeout_s
            self._warm[client_id] = WarmInstance(speed_factor=speed,
                                                warm_until=warm_until)
        else:
            self._warm.pop(client_id, None)

        plan = InvocationPlan(
            client_id=client_id, start_time=start_time, cold_start_s=cold_s,
            compute_s=compute, jitter_s=jitter, cold=was_cold,
            speed_factor=speed, failure=failure,
            function_timeout_s=self.config.function_timeout_s,
            warm_until=warm_until)
        if self.recorder is not None:
            self.recorder.on_plan(self.name, plan, attempt)
        return plan

    # ---- checkpoint surface (fl/checkpointing.py) --------------------
    def state_dict(self) -> dict:
        """JSON-ready snapshot of the platform's mutable state (RNG
        stream, warm pool, counters).  The virtual clock is owned by the
        training driver's snapshot — it is shared with the event queue."""
        return {
            "rng": self.rng.bit_generator.state,
            "warm": {cid: [inst.speed_factor, inst.warm_until]
                     for cid, inst in self._warm.items()},
            "cold_starts": self.cold_starts,
            "invocations": self.invocations,
        }

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._warm = {cid: WarmInstance(speed_factor=sf, warm_until=until)
                      for cid, (sf, until) in state.get("warm", {}).items()}
        self.cold_starts = int(state.get("cold_starts", 0))
        self.invocations = int(state.get("invocations", 0))

    def expire_warm(self, client_id: str, now: float) -> bool:
        """Event-driven scale-to-zero: evict iff the lease truly lapsed.

        A WARM_EXPIRY event scheduled for an old lease is stale once the
        instance was re-leased by a later invocation — the lease-time
        check makes stale events harmless no-ops.
        """
        inst = self._warm.get(client_id)
        if inst is not None and inst.warm_until <= now:
            del self._warm[client_id]
            return True
        return False

    def warm_instance_count(self) -> int:
        return len(self._warm)

    # ------------------------------------------------------------------
    def invoke(self, client_id: str, nominal_work_s: float,
               start_time: float,
               profile: Optional[ClientProfile] = None) -> InvocationOutcome:
        """One-shot convenience path: plan the attempt and collapse it to
        its outcome (the pre-event-engine API, kept for direct tests)."""
        return self.plan_invocation(client_id, nominal_work_s, start_time,
                                    profile).to_outcome()
