"""Discrete-event core of the serverless simulation.

The seed simulated each round as "invoke everyone at t0, compute every
finish time eagerly, filter at the deadline".  That shape cannot express
the behaviours the paper's claims rest on: retries (FedLess re-invokes
failed clients), per-round concurrency limits, warm instances expiring
*between* invocations, or a straggler's update physically arriving while
a *later* round is already running (Apodotiko-style true event ordering).

This module provides the deterministic event queue those behaviours hang
off: a binary heap keyed by ``(time, seq)`` over the existing
`VirtualClock`, where ``seq`` is a monotone schedule counter.  Two runs
with the same seeds schedule the same events in the same order and
therefore replay identically — determinism is a property of the key, not
of wall-clock luck.

Event kinds model the lifecycle of one serverless invocation:

    INVOKE_START      the invoker fires the HTTP request (or a retry)
    COLD_START_DONE   a cold instance finished booting (telemetry)
    CLIENT_FINISH     the client function returned its update
    PLATFORM_FAILURE  the platform reported an error / timeout kill
    WARM_EXPIRY       an idle warm instance scales to zero
    ROUND_DEADLINE    the controller's round timer fired

The queue is also the checkpoint substrate (fl/checkpointing.py): every
``data`` payload an event carries must be a plain JSON-serializable
record — platform references travel by *name*, never as live objects —
so ``state_dict``/``load_state_dict`` can snapshot the pending timeline
and a restored run replays the remaining events exactly, in-flight
stragglers included.  Restored events keep their original ``seq``, so
the (time, seq) replay order is byte-stable across a save/restore.
"""
from __future__ import annotations

import enum
import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .platform import VirtualClock


class EventKind(enum.Enum):
    INVOKE_START = "invoke_start"
    COLD_START_DONE = "cold_start_done"
    CLIENT_FINISH = "client_finish"
    PLATFORM_FAILURE = "platform_failure"
    WARM_EXPIRY = "warm_expiry"
    ROUND_DEADLINE = "round_deadline"


# compaction thresholds: rebuild the heap when cancelled tombstones
# outnumber live entries and the heap is big enough for it to matter
_COMPACT_MIN_SIZE = 64


# slots=True: at fleet scale the queue holds millions of Event objects;
# slotted instances drop the per-event __dict__ (~2x smaller, faster
# attribute access on the pop hot path)
@dataclass(slots=True)
class Event:
    time: float
    seq: int                       # schedule order — deterministic tiebreak
    kind: EventKind
    client_id: Optional[str] = None
    round_number: Optional[int] = None
    data: Dict[str, Any] = field(default_factory=dict)
    cancelled: bool = False
    # owning queue backref so lazy cancellation keeps the queue's live
    # counter exact (never serialized, never compared)
    _queue: Optional["EventQueue"] = field(default=None, repr=False,
                                           compare=False)

    def cancel(self) -> None:
        """Lazy cancellation: the heap entry stays, `pop` skips it."""
        if self.cancelled:
            return
        self.cancelled = True
        if self._queue is not None:
            self._queue._on_cancel()

    # ---- checkpoint surface ------------------------------------------
    def to_record(self) -> dict:
        """JSON-ready snapshot.  `data` must already be a plain record
        (strings/numbers/lists) — enforced by convention: every scheduler
        of events passes serializable payloads only."""
        return {"time": self.time, "seq": self.seq, "kind": self.kind.value,
                "client_id": self.client_id,
                "round_number": self.round_number, "data": dict(self.data)}

    @classmethod
    def from_record(cls, rec: dict) -> "Event":
        return cls(time=float(rec["time"]), seq=int(rec["seq"]),
                   kind=EventKind(rec["kind"]),
                   client_id=rec.get("client_id"),
                   round_number=rec.get("round_number"),
                   data=dict(rec.get("data", {})))


class EventQueue:
    """Deterministic future-event list on a shared `VirtualClock`.

    `pop` advances the clock to the popped event's time, so virtual time
    only ever moves at event boundaries and every consumer observes the
    same timeline.  Popped events are appended to `trace` — tests assert
    on it and it doubles as a simulation log.

    ``len(queue)`` is O(1): a live-event counter is maintained by
    `schedule`/`cancel`/`pop`, and the heap is compacted (cancelled
    tombstones dropped) whenever they outnumber the live entries.

    ``trace_maxlen`` bounds the popped-event log: the default (None)
    keeps the historical unbounded list, while fleet-scale runs pass a
    window size so memory stays O(window) over millions of events (the
    durable record stream is the TraceRecorder's job, not this log's).
    """

    def __init__(self, clock: Optional[VirtualClock] = None, recorder=None,
                 trace_maxlen: Optional[int] = None):
        self.clock = clock or VirtualClock()
        self._heap: List[tuple] = []
        self._next_seq = 0
        self._live = 0
        self.trace = (deque(maxlen=trace_maxlen)
                      if trace_maxlen is not None else [])
        # optional TraceRecorder (faas/trace.py): notified of every popped
        # event for opt-in event-stream export
        self.recorder = recorder

    # ------------------------------------------------------------------
    def schedule(self, time: float, kind: EventKind,
                 client_id: Optional[str] = None,
                 round_number: Optional[int] = None, **data: Any) -> Event:
        ev = Event(time=float(time), seq=self._next_seq, kind=kind,
                   client_id=client_id, round_number=round_number, data=data)
        self._next_seq += 1
        self._push(ev)
        return ev

    def _push(self, ev: Event) -> None:
        ev._queue = self
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        self._live += 1

    def pop(self) -> Optional[Event]:
        """Next live event (clock advances to it), or None when drained."""
        while self._heap:
            _, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            self._live -= 1
            # detach: a later cancel() of this already-delivered event
            # (fired deadlines, resolved lifecycles) must not decrement
            # the live counter a second time
            ev._queue = None
            self.clock.advance_to(ev.time)
            self.trace.append(ev)
            if self.recorder is not None:
                self.recorder.on_event(ev)
            return ev
        return None

    def peek_time(self) -> Optional[float]:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0

    # ---- lazy-cancellation bookkeeping --------------------------------
    def _on_cancel(self) -> None:
        self._live -= 1
        if (len(self._heap) >= _COMPACT_MIN_SIZE
                and self._live * 2 < len(self._heap)):
            self._compact()

    def _compact(self) -> None:
        """Drop cancelled tombstones: rebuild the heap from live events."""
        entries = [e for e in self._heap if not e[2].cancelled]
        heapq.heapify(entries)
        self._heap = entries

    # ---- checkpoint surface (fl/checkpointing.py) --------------------
    def state_dict(self) -> dict:
        """Snapshot the pending timeline: every live event (original seq
        preserved) plus the schedule counter, so a restored queue keeps
        scheduling new events past the old counter and replays the
        remaining (time, seq) order byte-identically."""
        live = sorted((e[2] for e in self._heap if not e[2].cancelled),
                      key=lambda ev: (ev.time, ev.seq))
        return {"next_seq": self._next_seq,
                "events": [ev.to_record() for ev in live]}

    def load_state_dict(self, state: dict) -> Dict[int, Event]:
        """Rebuild the pending timeline; returns ``{seq: Event}`` so
        callers holding event handles (the engine's cancellation lists,
        the async driver's deadline tickets) can re-link them."""
        self._heap = []
        self._live = 0
        by_seq: Dict[int, Event] = {}
        for rec in state.get("events", []):
            ev = Event.from_record(rec)
            self._push(ev)
            by_seq[ev.seq] = ev
        self._next_seq = int(state.get("next_seq", 0))
        return by_seq
