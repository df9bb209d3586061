"""Simulated serverless substrate: event queue, platforms, fleet, invoker,
GCF cost model, trace export."""
from .cost import (CostMeter, FreeTierAllowance, FunctionShape, PriceBook,
                   invocation_cost)
from .events import Event, EventKind, EventQueue
from .fleet import PlatformFleet, RoutingPolicy, TelemetryRoutingPolicy
from .invoker import (ClientCompletion, InvocationEngine, InvocationResult,
                      MockInvoker)
from .profiles import (PLATFORM_PROFILES, MultiPlatformInvoker,
                       make_platform)
from .platform import (ClientProfile, FaaSConfig, InvocationOutcome,
                       InvocationPlan, SimulatedFaaSPlatform, VirtualClock)
from .trace import TraceRecorder, load_jsonl

__all__ = [
    "CostMeter", "FreeTierAllowance", "FunctionShape", "PriceBook",
    "invocation_cost",
    "Event", "EventKind", "EventQueue",
    "PlatformFleet", "RoutingPolicy", "TelemetryRoutingPolicy",
    "ClientCompletion", "InvocationEngine", "InvocationResult", "MockInvoker",
    "ClientProfile", "FaaSConfig", "InvocationOutcome", "InvocationPlan",
    "SimulatedFaaSPlatform", "VirtualClock",
    "PLATFORM_PROFILES", "MultiPlatformInvoker", "make_platform",
    "TraceRecorder", "load_jsonl",
]
