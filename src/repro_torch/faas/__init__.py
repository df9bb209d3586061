"""Simulated serverless substrate: event queue, platform, invoker, GCF
cost model, trace export."""
from .cost import (CostMeter, FreeTierAllowance, FunctionShape, PriceBook,
                   invocation_cost)
from .events import Event, EventKind, EventQueue
from .invoker import (ClientCompletion, InvocationEngine, InvocationResult,
                      MockInvoker)
from .platform import (ClientProfile, FaaSConfig, InvocationOutcome,
                       InvocationPlan, SimulatedFaaSPlatform, VirtualClock)
from .trace import TraceRecorder, load_jsonl

__all__ = [
    "CostMeter", "FreeTierAllowance", "FunctionShape", "PriceBook",
    "invocation_cost",
    "Event", "EventKind", "EventQueue",
    "ClientCompletion", "InvocationEngine", "InvocationResult", "MockInvoker",
    "ClientProfile", "FaaSConfig", "InvocationOutcome", "InvocationPlan",
    "SimulatedFaaSPlatform", "VirtualClock",
    "TraceRecorder", "load_jsonl",
]
