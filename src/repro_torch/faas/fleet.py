"""Multi-provider platform fleet + routing policy.

FedLess is cloud-agnostic (paper §III-A): one experiment's clients may
live on GCF, AWS Lambda and a self-hosted OpenFaaS cluster at the same
time.  `PlatformFleet` holds a set of *named* `SimulatedFaaSPlatform`s
with distinct `FaaSConfig`/`FunctionShape`/`PriceBook` profiles, all
sharing one `VirtualClock`, and a `RoutingPolicy` that decides which
provider serves which client — so the controller stays completely
provider-agnostic while the simulation reproduces per-provider cold-start
spectra, SLOs, scale-to-zero windows and price books.

Routing modes:

  * ``sticky``       — explicit client→platform assignment with a default
                        (FedLess deployment files pin each client);
  * ``round-robin``  — unassigned clients are spread across providers in
                        deterministic rotation (multi-region load spread);
  * ``random``       — seeded random choice per new client (then sticky).

Regional-outage scenarios: `set_platform_down` marks a provider as
failing every invocation (failure_rate = 1), which the retry machinery in
the invoker then observes as repeated PLATFORM_FAILURE events.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..core.interning import ClientInterner, grow_to
from .platform import SimulatedFaaSPlatform, VirtualClock


class _AssignmentView:
    """Dict-compatible live view of a policy's array-backed sticky table.

    The historical `policy.assignment` surface was a plain ``{client_id:
    platform_name}`` dict; at fleet scale the table is an int64 array
    over interned client indices, and this view keeps the dict reads and
    writes working against it unchanged."""

    __slots__ = ("_policy",)

    def __init__(self, policy: "RoutingPolicy"):
        self._policy = policy

    def get(self, client_id: str, default=None):
        name = self._policy._get_assignment(client_id)
        return default if name is None else name

    def __getitem__(self, client_id: str) -> str:
        name = self._policy._get_assignment(client_id)
        if name is None:
            raise KeyError(client_id)
        return name

    def __setitem__(self, client_id: str, name: str) -> None:
        self._policy._set_assignment(client_id, name)

    def __contains__(self, client_id) -> bool:
        return self._policy._get_assignment(client_id) is not None

    def _pairs(self):
        pol = self._policy
        ids = pol._interner.ids
        table = pol._assigned
        for i in range(len(ids)):
            p = table[i]
            if p >= 0:
                yield ids[i], pol._names[int(p)]

    def __iter__(self):
        return (cid for cid, _ in self._pairs())

    def __len__(self) -> int:
        n = len(self._policy._interner)
        return int((self._policy._assigned[:n] >= 0).sum())

    def keys(self):
        return list(self)

    def values(self):
        return [name for _, name in self._pairs()]

    def items(self):
        return list(self._pairs())

    def __eq__(self, other):
        return dict(self._pairs()) == other

    def __repr__(self):
        return f"_AssignmentView({dict(self._pairs())!r})"


class RoutingPolicy:
    """Maps client ids to platform names; decisions are sticky so a
    client's warm instances stay meaningful across rounds.

    The sticky table is array-backed (interned client index → platform
    index) so a million registered clients cost one int64 slot each, not
    a dict entry of Python strings; `assignment` exposes the historical
    dict surface as a live view."""

    def __init__(self, platform_names: Sequence[str],
                 assignment: Optional[Dict[str, str]] = None,
                 default: Optional[str] = None,
                 mode: str = "sticky", seed: int = 0):
        if not platform_names:
            raise ValueError("RoutingPolicy needs at least one platform")
        self.platform_names = list(platform_names)
        # encoding table: routing candidates first, then any foreign
        # names seeded via explicit assignments
        self._names: List[str] = list(self.platform_names)
        self._name_idx: Dict[str, int] = {
            n: i for i, n in enumerate(self._names)}
        self._interner = ClientInterner()
        self._assigned = np.full(0, -1, dtype=np.int64)
        self.default = default or self.platform_names[0]
        if self.default not in self.platform_names:
            raise ValueError(f"default platform {self.default!r} not in "
                             f"{self.platform_names}")
        if mode not in ("sticky", "round-robin", "random"):
            raise ValueError(f"unknown routing mode {mode!r}")
        self.mode = mode
        self._rr = 0
        self._rng = np.random.default_rng(seed)
        self._default_idx = self._name_idx[self.default]
        for cid, name in (assignment or {}).items():
            self._set_assignment(cid, name)

    # ---- array-backed sticky table -----------------------------------
    @property
    def assignment(self) -> _AssignmentView:
        return _AssignmentView(self)

    def _get_assignment(self, client_id: str) -> Optional[str]:
        i = self._interner.lookup(client_id)
        if i < 0 or i >= self._assigned.size:
            return None
        p = self._assigned[i]
        return self._names[int(p)] if p >= 0 else None

    def _set_assignment(self, client_id: str, name: str) -> None:
        pi = self._name_idx.get(name)
        if pi is None:                       # foreign name: extend encoding
            pi = len(self._names)
            self._names.append(name)
            self._name_idx[name] = pi
        i = self._interner.intern(client_id)
        if i >= self._assigned.size:
            self._assigned = grow_to(
                self._assigned, len(self._interner), fill=-1)
        self._assigned[i] = pi

    def route(self, client_id: str) -> str:
        name = self._get_assignment(client_id)
        if name is not None:
            return name
        if self.mode == "round-robin":
            name = self.platform_names[self._rr % len(self.platform_names)]
            self._rr += 1
        elif self.mode == "random":
            name = str(self._rng.choice(self.platform_names))
        else:
            name = self.default
        self._set_assignment(client_id, name)  # sticky from now on
        return name

    def prefill(self, client_ids: Sequence[str]) -> None:
        """Bulk-assign every unassigned client in one vectorized pass —
        the fleet-scale fast path for registering a whole pool up front.
        Per-client results are identical to repeated `route` calls; the
        ``random`` mode falls back to scalar draws to preserve the RNG
        stream."""
        idx = self._interner.indices_for(client_ids)
        self._assigned = grow_to(self._assigned, len(self._interner),
                                 fill=-1)
        need = idx[self._assigned[idx] < 0]
        if need.size == 0:
            return
        if self.mode == "round-robin":
            k = len(self.platform_names)
            self._assigned[need] = (self._rr + np.arange(need.size)) % k
            self._rr += int(need.size)
        elif self.mode == "random":
            for i in need:                   # stream parity with route()
                self._assigned[i] = self._name_idx[
                    str(self._rng.choice(self.platform_names))]
        else:
            self._assigned[need] = self._default_idx

    # ---- checkpoint surface (fl/checkpointing.py) --------------------
    def state_dict(self) -> dict:
        """JSON-ready snapshot of the mutable routing state (sticky
        assignments, rotation cursor, RNG stream)."""
        return {"assignment": dict(self.assignment._pairs()),
                "rr": self._rr,
                "rng": self._rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self._interner = ClientInterner()
        self._assigned = np.full(0, -1, dtype=np.int64)
        for cid, name in state.get("assignment", {}).items():
            self._set_assignment(cid, name)
        self._rr = int(state.get("rr", 0))
        if "rng" in state:
            self._rng.bit_generator.state = state["rng"]


class TelemetryRoutingPolicy(RoutingPolicy):
    """Routing that reacts to the fleet's trace telemetry.

    Reads the rolling per-platform failure/cold-start rates that a
    `TraceRecorder` (faas/trace.py) accumulates from the platforms' plan
    stream (attach the recorder to the platforms, e.g.
    `PlatformFleet.attach_recorder`) and scores each provider as

        score = failure_weight · recent_failure_rate
              + cold_weight · recent_cold_start_rate

    New clients are routed to the lowest-scoring provider (deterministic
    name tie-break).  Assignments stay sticky — warm pools keep their
    meaning — *unless* the assigned provider's score crosses
    `reroute_threshold` (e.g. a regional outage observed as repeated
    failures), in which case the client is re-routed to the current best
    provider and a ``route`` record is emitted.  Providers with fewer
    than `min_samples` recent attempts score 0 (no evidence ≠ bad).
    """

    def __init__(self, platform_names: Sequence[str], recorder,
                 assignment: Optional[Dict[str, str]] = None,
                 default: Optional[str] = None, seed: int = 0,
                 failure_weight: float = 1.0, cold_weight: float = 0.25,
                 reroute_threshold: float = 0.5, min_samples: int = 5):
        super().__init__(platform_names, assignment, default,
                         mode="sticky", seed=seed)
        self.recorder = recorder
        self.failure_weight = failure_weight
        self.cold_weight = cold_weight
        self.reroute_threshold = reroute_threshold
        self.min_samples = min_samples

    def _score(self, name: str, stats: Dict[str, dict]) -> float:
        s = stats.get(name)
        if not s or s["attempts"] < self.min_samples:
            return 0.0
        return (self.failure_weight * s["failure_rate"]
                + self.cold_weight * s["cold_rate"])

    def route(self, client_id: str) -> str:
        stats = self.recorder.platform_stats()
        assigned = self.assignment.get(client_id)
        if assigned is not None:
            if self._score(assigned, stats) < self.reroute_threshold:
                return assigned
            reason = "reroute"
        else:
            reason = "assign"
        best = min(self.platform_names,
                   key=lambda n: (self._score(n, stats), n))
        if assigned is not None and best == assigned:
            return assigned       # degraded, but still the least-bad option
        self.assignment[client_id] = best
        self.recorder.route(client_id, best, reason)
        return best


class PlatformFleet:
    """Named platforms + routing on one shared virtual clock."""

    def __init__(self, platforms: Dict[str, SimulatedFaaSPlatform],
                 routing: Optional[RoutingPolicy] = None):
        if not platforms:
            raise ValueError("PlatformFleet needs at least one platform")
        self.platforms = dict(platforms)
        self.routing = routing or RoutingPolicy(list(self.platforms))
        self.clock = VirtualClock()
        for p in self.platforms.values():
            p.clock = self.clock
        self._saved_failure_rates: Dict[str, float] = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_profiles(cls, names: Optional[Iterable[str]] = None,
                      routing: Optional[RoutingPolicy] = None,
                      seed: int = 0) -> "PlatformFleet":
        """Build a fleet from the provider profile book (faas/profiles.py).

        Each platform gets a distinct RNG stream (seed + index) so
        provider timing draws are independent but reproducible.
        """
        from .profiles import PLATFORM_PROFILES   # circular-free at call time
        names = list(names) if names is not None else list(PLATFORM_PROFILES)
        platforms = {}
        for i, name in enumerate(names):
            prof = PLATFORM_PROFILES[name]
            platforms[name] = SimulatedFaaSPlatform(
                prof["faas"], prof["shape"], seed=seed + i, name=name)
        return cls(platforms, routing)

    # ------------------------------------------------------------------
    def platform_of(self, client_id: str) -> SimulatedFaaSPlatform:
        return self.platforms[self.routing.route(client_id)]

    def name_of(self, client_id: str) -> str:
        return self.routing.route(client_id)

    @property
    def default_platform(self) -> SimulatedFaaSPlatform:
        return self.platforms[self.routing.default]

    def attach_recorder(self, recorder) -> None:
        """Point every platform's plan telemetry at `recorder` (the
        routing policy may independently hold the same recorder)."""
        for p in self.platforms.values():
            p.recorder = recorder

    # ---- checkpoint surface (fl/checkpointing.py) --------------------
    def state_dict(self) -> dict:
        """Snapshot every platform's mutable state (RNG streams, warm
        pools, counters) plus the routing decisions — the multi-provider
        twin of `SimulatedFaaSPlatform.state_dict`.  The shared virtual
        clock is owned by the training driver's snapshot."""
        return {"platforms": {name: p.state_dict()
                              for name, p in self.platforms.items()},
                "routing": self.routing.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        for name, pstate in state.get("platforms", {}).items():
            if name in self.platforms:
                self.platforms[name].load_state_dict(pstate)
        self.routing.load_state_dict(state.get("routing", {}))

    # ---- scenario knobs ----------------------------------------------
    def set_platform_down(self, name: str, down: bool = True) -> None:
        """Regional outage: every invocation on `name` fails (SLO → 0)."""
        p = self.platforms[name]
        if down:
            self._saved_failure_rates.setdefault(name, p.config.failure_rate)
            p.config = replace(p.config, failure_rate=1.0)
        elif name in self._saved_failure_rates:
            p.config = replace(
                p.config, failure_rate=self._saved_failure_rates.pop(name))

    # ---- fleet-wide telemetry ----------------------------------------
    @property
    def invocations(self) -> int:
        return sum(p.invocations for p in self.platforms.values())

    @property
    def cold_starts(self) -> int:
        return sum(p.cold_starts for p in self.platforms.values())

    def utilisation(self) -> Dict[str, Dict[str, int]]:
        return {name: {"invocations": p.invocations,
                       "cold_starts": p.cold_starts,
                       "warm_instances": p.warm_instance_count()}
                for name, p in self.platforms.items()}
