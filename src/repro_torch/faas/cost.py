"""GCF gen-2 cost model (paper §VI-A5 / [85]).

Google bills 2nd-gen Cloud Functions per vCPU-second, per GiB-second of
memory, and per million invocations (Tier-1 prices, 2022):

    vCPU-second   $0.0000240
    GiB-second    $0.0000025
    invocations   $0.40 / 1e6

Gen-2 functions get a vCPU allocation proportional to memory
(2048 MB → 1 vCPU, the paper's client config).  The paper estimates a
straggler's cost as running for the *entire round duration* (§VI-C), which
`straggler_invocation_cost` reproduces.

When `PriceBook.free_tier` is set, the monthly GCF free tier (2M
invocations, 180k vCPU-seconds, 360k GiB-seconds) is consumed first: a
`FreeTierAllowance` tracks the remaining grant and `invocation_cost`
only bills usage beyond it.  The paper reports raw costs (free tier
off), which stays the default.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class PriceBook:
    vcpu_second: float = 0.0000240
    gib_second: float = 0.0000025
    per_invocation: float = 0.40 / 1_000_000
    # internet egress for the client's update upload (GCP premium tier,
    # first TiB); only billed when updates carry a simulated wire size
    egress_per_gib: float = 0.12
    free_tier: bool = False  # paper reports raw costs, no free tier


def egress_cost(payload_bytes: int,
                prices: Optional[PriceBook] = None) -> float:
    """Cost of shipping one encoded client update to the server."""
    prices = prices if prices is not None else PriceBook()
    return (payload_bytes / 2**30) * prices.egress_per_gib


@dataclass
class FreeTierAllowance:
    """Remaining monthly free-tier grant (GCF gen-2 public quotas)."""
    invocations: float = 2_000_000.0
    vcpu_seconds: float = 180_000.0
    gib_seconds: float = 360_000.0

    def consume(self, attr: str, amount: float) -> float:
        """Consume up to `amount` from the grant; return the *billable*
        remainder that exceeded it."""
        remaining = getattr(self, attr)
        free = min(amount, remaining)
        setattr(self, attr, remaining - free)
        return amount - free


@dataclass(frozen=True)
class FunctionShape:
    memory_mb: int = 2048
    vcpus: float = 1.0
    timeout_s: float = 540.0   # paper's client function timeout


def invocation_cost(duration_s: float, shape: FunctionShape,
                    prices: Optional[PriceBook] = None,
                    allowance: Optional[FreeTierAllowance] = None) -> float:
    """Cost of one function invocation running for `duration_s` seconds.

    GCF bills duration rounded up to the nearest 100 ms increment.  With
    `prices.free_tier` and an `allowance`, the free-tier grant is drawn
    down first and only the excess is billed (the allowance is mutated).
    """
    prices = prices if prices is not None else PriceBook()
    billed = max(0.1, -(-duration_s // 0.1) * 0.1)  # ceil to 100 ms
    gib = shape.memory_mb / 1024.0
    vcpu_s = billed * shape.vcpus
    gib_s = billed * gib
    n_inv = 1.0
    if prices.free_tier and allowance is not None:
        vcpu_s = allowance.consume("vcpu_seconds", vcpu_s)
        gib_s = allowance.consume("gib_seconds", gib_s)
        n_inv = allowance.consume("invocations", n_inv)
    return (vcpu_s * prices.vcpu_second
            + gib_s * prices.gib_second
            + n_inv * prices.per_invocation)


def straggler_invocation_cost(round_duration_s: float, shape: FunctionShape,
                              prices: Optional[PriceBook] = None,
                              allowance: Optional[FreeTierAllowance] = None
                              ) -> float:
    """Paper §VI-C: a straggler is charged as if it ran the whole round."""
    return invocation_cost(round_duration_s, shape, prices, allowance)


class CostMeter:
    """Accumulates experiment cost across invocations (one per client call).

    Beyond the total, the meter attributes every charge to the client and
    round (or async model version) it was incurred for — `by_client` and
    `rounds` — and, when a `TraceRecorder` is attached, emits one billing
    record per charge so the JSONL trace reconstructs `total` exactly.
    """

    def __init__(self, shape: Optional[FunctionShape] = None,
                 prices: Optional[PriceBook] = None, trace=None):
        self.shape = shape if shape is not None else FunctionShape()
        self.prices = prices if prices is not None else PriceBook()
        self.trace = trace
        self.total = 0.0
        self.invocations = 0
        self.by_client: Dict[str, float] = {}
        self.rounds: Dict[int, float] = {}
        self.allowance = (FreeTierAllowance()
                          if self.prices.free_tier else None)

    def _record(self, cost: float, duration_s: float, kind: str,
                client_id: Optional[str], round_number) -> float:
        self.total += cost
        self.invocations += 1
        if client_id is not None:
            self.by_client[client_id] = self.by_client.get(client_id, 0.0) + cost
        if round_number is not None:
            self.rounds[round_number] = self.rounds.get(round_number, 0.0) + cost
        if self.trace is not None:
            self.trace.billing(cost=cost, duration_s=duration_s, kind=kind,
                               client_id=client_id, round_number=round_number)
        return cost

    def charge(self, duration_s: float, client_id: Optional[str] = None,
               round_number=None, kind: str = "attempt") -> float:
        c = invocation_cost(duration_s, self.shape, self.prices,
                            self.allowance)
        return self._record(c, duration_s, kind, client_id, round_number)

    def charge_egress(self, payload_bytes: Optional[int],
                      client_id: Optional[str] = None,
                      round_number=None) -> float:
        """Bill one update upload's egress.  None (dense runs) is a free
        no-op with no billing record — the compressed-vs-plaintext trace
        diff is exactly the egress lines."""
        if payload_bytes is None:
            return 0.0
        c = egress_cost(payload_bytes, self.prices)
        return self._record(c, 0.0, "egress", client_id, round_number)

    def charge_straggler(self, round_duration_s: float,
                         client_id: Optional[str] = None,
                         round_number=None) -> float:
        c = straggler_invocation_cost(round_duration_s, self.shape,
                                      self.prices, self.allowance)
        return self._record(c, round_duration_s, "straggler", client_id,
                            round_number)

    # ---- checkpoint surface (fl/checkpointing.py) --------------------
    def state_dict(self) -> dict:
        """JSON-ready snapshot of the tallies.  Round keys are ints in
        memory but JSON object keys are strings — serialization stringifies
        them here and `load_state_dict` casts them back, so a resumed
        meter's `rounds` keys stay ints and per-round totals keep
        accumulating into the same buckets."""
        state = {
            "total": self.total,
            "invocations": self.invocations,
            "by_client": dict(self.by_client),
            "rounds": {str(k): v for k, v in self.rounds.items()},
        }
        if self.allowance is not None:
            # free-tier billing: the remaining monthly grant is part of
            # the cost state (a resumed run must not re-grant it)
            state["allowance"] = {
                "invocations": self.allowance.invocations,
                "vcpu_seconds": self.allowance.vcpu_seconds,
                "gib_seconds": self.allowance.gib_seconds,
            }
        return state

    def load_state_dict(self, state: dict) -> None:
        self.total = float(state.get("total", 0.0))
        self.invocations = int(state.get("invocations", 0))
        self.by_client = dict(state.get("by_client", {}))
        self.rounds = {int(k): v
                       for k, v in state.get("rounds", {}).items()}
        if "allowance" in state and self.allowance is not None:
            for attr, left in state["allowance"].items():
                setattr(self.allowance, attr, float(left))
