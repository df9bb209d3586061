"""Per-provider FaaS platform profiles + multi-platform invoker.

FedLess is cloud-agnostic (paper §III-A): clients may live on GCF, AWS
Lambda, or a self-hosted OpenFaaS cluster simultaneously.  Profiles carry
provider-measured characteristics (cold-start medians, SLO, billing);
`MultiPlatformInvoker` routes each client to its platform while keeping
the controller completely provider-agnostic.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .cost import FunctionShape, PriceBook
from .fleet import PlatformFleet, RoutingPolicy
from .invoker import ClientWorkFn, InvocationResult
from .platform import ClientProfile, FaaSConfig, SimulatedFaaSPlatform

Pytree = Any

# Provider characteristics (public measurements: Wang et al. ATC'18,
# provider docs; prices: 2022 price books used by the paper's cost model)
PLATFORM_PROFILES: Dict[str, dict] = {
    "gcf-gen2": dict(
        faas=FaaSConfig(cold_start_median_s=3.0, cold_start_sigma=0.5,
                        warm_idle_timeout_s=900.0, failure_rate=0.0005,
                        function_timeout_s=3600.0),
        shape=FunctionShape(memory_mb=2048, vcpus=1.0, timeout_s=540.0),
        prices=PriceBook(vcpu_second=0.0000240, gib_second=0.0000025,
                         per_invocation=0.40 / 1e6)),
    "aws-lambda": dict(
        faas=FaaSConfig(cold_start_median_s=1.2, cold_start_sigma=0.6,
                        warm_idle_timeout_s=420.0, failure_rate=0.0003,
                        function_timeout_s=900.0),
        shape=FunctionShape(memory_mb=2048, vcpus=1.2, timeout_s=900.0),
        prices=PriceBook(vcpu_second=0.0, gib_second=0.0000167,
                         per_invocation=0.20 / 1e6)),
    "openfaas": dict(
        faas=FaaSConfig(cold_start_median_s=8.0, cold_start_sigma=0.8,
                        warm_idle_timeout_s=300.0, failure_rate=0.002,
                        perf_variation=(0.7, 1.6),
                        function_timeout_s=1800.0),
        shape=FunctionShape(memory_mb=4096, vcpus=1.0, timeout_s=1800.0),
        # self-hosted: amortised VM cost expressed per-second
        prices=PriceBook(vcpu_second=0.0000110, gib_second=0.0000015,
                         per_invocation=0.0)),
}


def make_platform(profile: str, seed: int = 0) -> SimulatedFaaSPlatform:
    p = PLATFORM_PROFILES[profile]
    return SimulatedFaaSPlatform(p["faas"], p["shape"], seed=seed,
                                 name=profile)


class MultiPlatformInvoker:
    """Routes each client to its provider's simulated platform.

    A thin invoker facade over `fleet.PlatformFleet`: `assignment` maps
    client_id → profile name; unassigned clients use `default` (or the
    fleet routing mode).  Presents the same interface as MockInvoker so
    the controller doesn't change (the paper's provider-agnostic design).
    """

    def __init__(self, work_fn: ClientWorkFn,
                 assignment: Dict[str, str],
                 profiles: Optional[Dict[str, ClientProfile]] = None,
                 default: str = "gcf-gen2", seed: int = 0,
                 routing_mode: str = "sticky"):
        self.work_fn = work_fn
        self.profiles = profiles or {}
        self.default = default
        self.fleet = PlatformFleet.from_profiles(
            routing=RoutingPolicy(list(PLATFORM_PROFILES),
                                  assignment=assignment, default=default,
                                  mode=routing_mode, seed=seed),
            seed=seed)
        self.platforms = self.fleet.platforms
        self.assignment = self.fleet.routing.assignment
        self.platform = self.platforms[default]

    def platform_of(self, cid: str) -> SimulatedFaaSPlatform:
        return self.fleet.platform_of(cid)

    def invoke_clients(self, client_ids: Sequence[str],
                       global_params: Pytree, round_number: int,
                       start_time: float) -> List[InvocationResult]:
        results = []
        for cid in client_ids:
            platform = self.platform_of(cid)
            profile = self.profiles.get(cid, ClientProfile())
            if profile.crash:
                outcome = platform.invoke(cid, 0.0, start_time, profile)
                results.append(InvocationResult(outcome=outcome,
                                                update=None))
                continue
            update, nominal_s = self.work_fn(cid, global_params,
                                             round_number)
            outcome = platform.invoke(cid, nominal_s, start_time, profile)
            results.append(InvocationResult(
                outcome=outcome,
                update=None if outcome.crashed else update))
        return results
