"""Reduction of a ``torch.profiler`` session to the device's timeline.

A traced run profiles a few whole rounds or steps after its measured
window, with the host's spans (``bench.<name>``, the harness's own,
around its calls into each layer of the program) recorded as
``record_function`` ranges.  From the trace: the busy time (the union of
the device operations' intervals) inside the traced window, device time
by kernel name, device time under a program span (a ``record_function``
on the device timeline), the device operations that took the most time,
and the idle gaps named by the innermost host span open when each began.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW_SPAN = "bench.traced_window"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class DeviceTrace:
    """Times in seconds on the trace's clock."""
    window: Tuple[float, float]
    ops: List[Tuple[str, float, float]]            # (name, start, end)
    annotations: Dict[str, List[Tuple[float, float]]]
    host_spans: List[Tuple[str, float, float]]
    calls: Dict[str, list] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return _union([(max(s, lo), min(e, hi)) for _, s, e in self.ops
                       if e > lo and s < hi])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``names``."""
        return sum(e - s for n, s, e in self.ops
                   if any(k in n for k in names))

    def under_span_s(self, span: str) -> float:
        """Device seconds of the operations that start inside a device
        range of the program span ``span``."""
        ranges = _union(self.annotations.get(span, []))
        starts = [s for s, _ in ranges]
        total = 0.0
        for _, s, e in self.ops:
            i = bisect_right(starts, s) - 1
            if i >= 0 and s < ranges[i][1]:
                total += e - s
        return total

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle seconds inside the window, summed by the innermost host
        span open at each gap's start."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        spans = sorted(self.host_spans, key=lambda x: x[1])
        by: Dict[str, float] = {}
        for gs, ge in gaps:
            label, width = "bench.outside_spans", float("inf")
            for name, s, e in spans:
                if s > gs:
                    break
                if e >= gs and name != WINDOW_SPAN and e - s < width:
                    label, width = name, e - s
            by[label] = by.get(label, 0.0) + (ge - gs)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def reduce(prof) -> DeviceTrace:
    """The ``DeviceTrace`` of a finished ``torch.profiler.profile``
    session, its window the ``bench.traced_window`` host range."""
    ops, annotations, host, window = [], {}, [], None
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == cuda:
            # a record_function range shows on the device timeline as an
            # annotation over its kernels: a span, not busy time
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith("bench.") or \
                    e.name == "ssd_scan_plain_backward":
                annotations.setdefault(e.name, []).append((s, t))
            else:
                ops.append((e.name, s, t))
        elif e.name == WINDOW_SPAN:
            window = (s, t)
        elif e.name.startswith("bench."):
            host.append((e.name, s, t))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} range")
    return DeviceTrace(window, ops, annotations, host)
