"""The program's own spans and counters in a traced run.

The port's tracing (``repro_torch.tracing``) is on while a torch
profiler records, so the rounds or steps a traced run profiles after its
window leave their spans and counters in the program's memory, and each
span a ``record_function`` range on the trace's clock: a host range and
a device annotation over the kernels launched inside it.  The readers of
the program's metrics take the spans and counters from ``drained``,
which drains the program once a run.  A program without the tracing
module, or a run that recorded nothing, gives ``None``, and those
metrics are left out.

``busy_under_s`` is the device's busy time under a program span: the
union of the intervals of the operations that start inside its device
ranges.  In the FL cell's traces the operations' intervals overlap (their
durations sum past the window), so a sum of durations, as
``DeviceTrace.under_span_s`` takes it, would count time twice.

``reduce`` is ``trace.reduce`` given the program's span names: each
span's device range filed as an annotation, never as a device operation
(so busy time and the top operations are as without spans), and its
host range among the host spans that name the idle gaps, the innermost
of harness and program spans naming each gap.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

import torch

from bench_port import trace as tr

_DRAINED: Dict[int, tuple] = {}


def drained(run) -> Optional[Tuple[list, Dict[str, int]]]:
    """The program's span records and counters of ``run``: drained from
    the program at the first call, kept for the run's other readers;
    ``None`` where there are none."""
    key = id(run)
    if key not in _DRAINED:
        try:
            from repro_torch import tracing
        except ImportError:
            got = None
        else:
            records, counts = tracing.drain()
            got = (records, counts) if records or counts else None
        _DRAINED[key] = (run, got)      # the run held: its id stays its own
    return _DRAINED[key][1]


def _ms(record) -> float:
    return (record.end_ns - record.start_ns) / 1e6


def rounds(run) -> List:
    """The ``fl.round`` records of an fl run's traced rounds."""
    got = drained(run) if run.kind == "fl" else None
    return [] if got is None else [r for r in got[0] if r.name == "fl.round"]


def host_ms_per_round(run, name: str) -> Optional[float]:
    """Host ms a traced round inside the span ``name``, over the rounds
    that hold one."""
    per_round = rounds(run)
    spans = [r for r in drained(run)[0] if r.name == name] \
        if per_round else []
    if not spans:
        return None
    return sum(_ms(r) for r in spans) / len(per_round)


def self_ms_per_round(run) -> Optional[float]:
    """Host ms a traced round in ``fl.round`` outside its child spans."""
    per_round = rounds(run)
    if not per_round:
        return None
    children: Dict[object, float] = {}
    for r in drained(run)[0]:
        if r.parent == "fl.round":
            rnd = r.attrs.get("round")
            children[rnd] = children.get(rnd, 0.0) + _ms(r)
    return sum(_ms(r) - children.get(r.attrs.get("round"), 0.0)
               for r in per_round) / len(per_round)


def counter(run, name: str) -> int:
    got = drained(run)
    return 0 if got is None else int(got[1].get(name, 0))


def busy_under_s(t: tr.DeviceTrace, span: str) -> float:
    """Busy device seconds under the program span ``span``."""
    ranges = tr._union(t.annotations.get(span, []))
    starts = [s for s, _ in ranges]
    inside = []
    for _, s, e in t.ops:
        i = bisect_right(starts, s) - 1
        if i >= 0 and s < ranges[i][1]:
            inside.append((s, e))
    return sum(e - s for s, e in tr._union(inside))


def reduce(prof, span_names) -> tr.DeviceTrace:
    """``trace.reduce`` of a finished profiler session, the program's
    spans ``span_names`` filed as annotations and host spans."""
    out = tr.reduce(prof)
    span_names = set(span_names)
    kept = []
    for op in out.ops:
        if op[0] in span_names:
            out.annotations.setdefault(op[0], []).append((op[1], op[2]))
        else:
            kept.append(op)
    out.ops = kept
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if e.device_type != cuda and e.name in span_names:
            out.host_spans.append((e.name, e.time_range.start / 1e6,
                                   e.time_range.end / 1e6))
    return out
