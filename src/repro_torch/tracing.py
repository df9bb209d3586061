"""The port's spans and counters: where a round's or a step's host time
goes, on the profiler's clock when a profiler runs.

Tracing is off by default.  It is on while ``enable()`` has turned it
on, and while a ``torch.profiler`` session records on this thread, so a
profiled run gets the program's spans without a call.  Off, ``span``
returns one shared no-op context manager and ``count`` returns at once.
On:

* ``span(name, **attrs)`` keeps a ``SpanRecord`` (name, the innermost
  open span's name as ``parent``, ``perf_counter_ns`` start and end,
  attrs) and opens ``torch.profiler.record_function(name)``, which a
  profiler shows as a host range and as a device annotation over the
  kernels launched inside.  A span takes the ``round`` or ``step`` of the
  span it opens in unless it names its own, so a round's spans share it;
* ``count(name, n)`` adds ``n`` to a counter;
* ``drain()`` hands back the records and counters and clears them.

``SPANS`` and ``COUNTERS`` name each span and counter and what reads it;
a name outside them raises.  Nothing recorded here feeds virtual time, a
trace record, a checkpoint or a result: the clock reads live in this
module, outside the simulation packages.  Spans are kept for one thread
(the TrainingDriver's).  With tracing on, the merge waits for the card inside
``fl.device_wait`` (core/merge.py), so a round's wait is its own span.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# each span, and the metric (bench_port/metrics/) or use that reads it
SPANS: Dict[str, str] = {
    "fl.round": "driver_self_ms_per_round.fl: TrainingDriver.run_round, "
                "one barrier round",
    "fl.aggregate": "driver_self_ms_per_round.fl: the strategy's "
                    "aggregate inside a round",
    "fl.stage": "executor_stage_ms_per_round.fl: a group's inputs built "
                "on the host and uploaded",
    "fl.steps": "executor_device_ms_per_step.fl: a group's local steps",
    "fl.optimizer": "optimizer_share.fl: the proximal term, optimizer "
                    "and apply of one executor step",
    "fl.device_wait": "device_wait_ms_per_round.fl: the merge's wait for "
                      "the card before it uploads",
    "train.optimizer": "optimizer_share.train: optimizer and apply of one "
                       "make_train_step step",
    "moe": "moe_share.train: one 'moe' block's mixer (models/moe.py "
           "moe_layer: router, dispatch, held experts, combine, shared "
           "expert), its forward passes (remat's rerun too), not autograd's "
           "backward",
    "moe.experts": "moe_experts_roofline.train: the held experts' matrix "
                   "products inside ``moe``, forward passes only",
    # a bare record_function in kernels/ssd_scan.py, opened whether or
    # not tracing is on, since chip_smoke.py profiles it without enabling
    # tracing; it is never kept in memory
    "ssd_scan_plain_backward": "ssd_backward_share.train and "
                               "chip_smoke.py: the scan's backward, the "
                               "backward kernels on the card (the name is "
                               "kept for the benchmark's reader), the "
                               "plain version's VJP on the CPU",
}

# each counter, and the metric that reads it
COUNTERS: Dict[str, str] = {
    "fl.local_steps": "executor_device_ms_per_step.fl: local steps of "
                      "the executor's groups",
    "moe.routed_pairs": "moe_experts_roofline.train and the hybrid train "
                        "cell's model FLOPs: token-expert pairs a 'moe' "
                        "block computed on its held experts, in each "
                        "forward pass (remat's rerun counts again)",
    "moe.max_expert_rows": "expert_load_max_over_mean.train: the largest "
                           "held expert's rows in a 'moe' block, summed "
                           "over the calls counted as moe.routed_pairs",
}

# the attrs a span takes from the span it opens in
IDS = ("round", "step")


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    attrs: dict


_ON = False
_STACK: List["_Span"] = []
_RECORDS: List[SpanRecord] = []
_COUNTS: Dict[str, int] = {}


def enable(on: bool = True) -> None:
    """Turn tracing on (or off) for the process."""
    global _ON
    _ON = bool(on)


def enabled() -> bool:
    """Whether spans and counters record now: ``enable()``'s flag, or a
    torch profiler recording on this thread."""
    return _ON or torch.autograd._profiler_enabled()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "parent", "start", "range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        outer = _STACK[-1] if _STACK else None
        self.parent = None if outer is None else outer.name
        if outer is not None:
            for key in IDS:
                if key in outer.attrs and key not in self.attrs:
                    self.attrs[key] = outer.attrs[key]
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        _STACK.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _STACK.pop()
        self.range.__exit__(*exc)
        _RECORDS.append(SpanRecord(self.name, self.parent, self.start, end,
                                   self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager over one span of ``SPANS`` (see the module)."""
    if not enabled():
        return _OFF
    if name not in SPANS:
        raise KeyError(f"unregistered span {name!r}; add it to SPANS")
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of ``COUNTERS`` when tracing is
    on."""
    if not enabled():
        return
    if name not in COUNTERS:
        raise KeyError(f"unregistered counter {name!r}; add it to COUNTERS")
    _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def drain() -> Tuple[List[SpanRecord], Dict[str, int]]:
    """The closed spans in the order they closed and the counters, both
    cleared here."""
    records, counts = list(_RECORDS), dict(_COUNTS)
    _RECORDS.clear()
    _COUNTS.clear()
    return records, counts
