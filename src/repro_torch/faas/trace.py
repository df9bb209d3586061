"""Event-driven trace export + rolling fleet telemetry.

`TraceRecorder` is the single sink every layer of the simulation reports
into: the platform reports sampled invocation plans (cold starts), the
invocation engine reports one record per resolved invocation *attempt*
(cold start, retry index, billed duration, arrival virtual time, routing
decision), the cost meter reports every billed charge, and the training
driver reports every aggregation event and every scheduler cohort
decision (``scheduling`` records).  Records are plain dicts dumped
as JSONL, so a full experiment round-trips: summing the ``billing``
records reconstructs ``CostMeter.total`` exactly, and the attempt stream
replays the schedule the event queue produced.

Because everything runs on the virtual clock, two same-seed runs emit
byte-identical traces — the recorder never reads wall-clock time.

Fleet scale: by default all records buffer in memory (`records`), which
is exactly the historical behaviour.  Passing ``stream_path`` turns the
recorder into a streaming writer: records accumulate in a bounded
buffer and are appended to the JSONL file every ``flush_every`` records,
so memory stays O(flush_every) at any trace length; ``shard_records``
additionally rotates the stream across numbered shard files
(``<stem>.00000.jsonl``, ``<stem>.00001.jsonl``, …) for multi-gigabyte
runs.  The streamed bytes are the exact `dumps()` bytes — same-seed
runs produce byte-identical output in either mode — and the read-back
surface (`select`, `billed_total`, `dumps`, `record_count`) spans
flushed shards plus the live buffer transparently.

The recorder also keeps a *rolling window* of per-platform attempt
outcomes (failures, cold starts), fed exclusively by the platform-side
`on_plan` hook — one observation per sampled attempt, including crash
plans that never surface as events — so attaching the same recorder to
the engine as well never double-counts.  `platform_stats()` exposes it
as recent failure/cold-start rates, which
`faas.fleet.TelemetryRoutingPolicy` reads to de-prioritize degraded
providers (the platforms must therefore carry the recorder, e.g. via
`PlatformFleet.attach_recorder`).
"""
from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Dict, FrozenSet, Iterator, List, Optional

# record types emitted into the JSONL stream
REC_ATTEMPT = "attempt"
REC_BILLING = "billing"
REC_AGGREGATION = "aggregation"
REC_ROUTE = "route"
REC_EVENT = "event"
REC_SCHEDULING = "scheduling"

# The declared key-set contract for every record type.  Golden trace
# tests compare *bytes*, so the exact keys each sink emits are part of
# the public surface: "required" keys appear in every record of that
# type, "optional" keys only under documented conditions (compression
# on, barrier-free round aliasing, ...), and "open" marks the two sinks
# that accept **extra metadata (aggregation/scheduling payloads).
# repro-lint's CON002 statically checks the sink literals below against
# this table — extend the table and the golden fixtures together.
RECORD_SCHEMAS = {
    REC_ATTEMPT: {
        "required": ["client_id", "platform", "round", "attempt",
                     "start_time", "arrival_time", "cold",
                     "cold_start_s", "billed_s", "status"],
        "optional": ["payload_bytes", "dispatch_s", "ticket"],
        "open": False,
    },
    REC_BILLING: {
        "required": ["cost", "duration_s", "kind", "client_id",
                     "round"],
        "optional": [],
        "open": False,
    },
    REC_AGGREGATION: {
        "required": ["time", "round", "merged", "strategy", "mode"],
        "optional": [],
        "open": True,       # server_opt/update_norm/compression extras
    },
    REC_SCHEDULING: {
        "required": ["time", "round", "scheduler", "mode", "want",
                     "selected", "pool_size"],
        "optional": [],
        "open": True,       # per-scheduler payload (tiers, score stats)
    },
    REC_ROUTE: {
        "required": ["client_id", "platform", "reason"],
        "optional": [],
        "open": False,
    },
    REC_EVENT: {
        "required": ["time", "kind", "client_id", "round"],
        "optional": [],
        "open": False,
    },
}

_UNSHARDED_ROOM = 1 << 62


def _dump_line(rec: dict) -> str:
    """One canonical JSONL line (deterministic: sorted keys,
    repr-round-trip floats) — the single formatter both the in-memory
    and the streaming paths go through."""
    return json.dumps(rec, sort_keys=True) + "\n"


class TraceRecorder:
    """Collects simulation records and rolling per-platform telemetry."""

    def __init__(self, telemetry_window: int = 50,
                 event_kinds: Optional[FrozenSet[str]] = None,
                 stream_path=None, flush_every: int = 4096,
                 shard_records: Optional[int] = None):
        self.records: List[dict] = []       # in-memory buffer
        self.telemetry_window = telemetry_window
        # queue-event logging is opt-in (the attempt stream already covers
        # the invocation lifecycle); pass e.g. {"round_deadline"}
        self.event_kinds = event_kinds or frozenset()
        self._windows: Dict[str, deque] = {}
        self._round_aliases: Dict[int, int] = {}
        # streaming mode (None = buffer everything, the historical default)
        self.stream_path = Path(stream_path) if stream_path else None
        self.flush_every = max(1, int(flush_every))
        self.shard_records = shard_records
        self._flushed = 0                   # records already on disk
        self._shards: List[Path] = []
        self._shard_counts: List[int] = []

    @property
    def record_count(self) -> int:
        """Total records emitted so far (flushed + buffered) — the
        checkpoint trace-offset surface at any fleet size."""
        return self._flushed + len(self.records)

    @property
    def streaming(self) -> bool:
        return self.stream_path is not None

    def alias_round(self, engine_round: int, reported_round) -> None:
        """Barrier-free mode: the engine schedules each invocation as its
        own synthetic ticket; aliasing maps the ticket onto the current
        model version (the driver refreshes it at resolution time), so
        attempt records share a 'round' number space with billing and
        aggregation records.  The original ticket id is preserved in the
        record's 'ticket' field."""
        self._round_aliases[engine_round] = reported_round

    def _append(self, rec: dict) -> None:
        self.records.append(rec)
        if (self.stream_path is not None
                and len(self.records) >= self.flush_every):
            self.flush()

    # ---- sinks (called by the simulation layers) ----------------------
    def attempt(self, *, client_id: str, platform: str, round_number,
                attempt: int, start_time: float, arrival_time: float,
                cold: bool, cold_start_s: float, billed_s: float,
                status: str, payload_bytes: Optional[int] = None,
                dispatch_s: Optional[float] = None) -> None:
        """One resolved invocation attempt (success, failure, or a crash
        discovered at a deadline).  `status` is "ok" or a failure reason
        from faas.platform (crash/platform/timeout).  `payload_bytes` is
        the update's simulated wire size when compression is on — None
        (the dense default) keeps the record's key set byte-identical to
        pre-compression traces.  `dispatch_s` is the executor's wall-clock
        group-dispatch latency when timing collection is on — same
        only-when-set rule, so default traces never gain the key.  Pure
        record sink — telemetry windows are fed by `on_plan` (one
        observation per sampled attempt), never here, so a recorder
        attached to both the engine and the platforms counts each attempt
        once."""
        rec = {
            "type": REC_ATTEMPT, "client_id": client_id,
            "platform": platform, "round": round_number,
            "attempt": attempt, "start_time": start_time,
            "arrival_time": arrival_time, "cold": cold,
            "cold_start_s": cold_start_s, "billed_s": billed_s,
            "status": status,
        }
        if payload_bytes is not None:
            rec["payload_bytes"] = payload_bytes
        if dispatch_s is not None:
            rec["dispatch_s"] = dispatch_s
        if round_number in self._round_aliases:
            rec["ticket"] = round_number
            rec["round"] = self._round_aliases[round_number]
        self._append(rec)

    def billing(self, *, cost: float, duration_s: float, kind: str,
                client_id: Optional[str] = None,
                round_number=None) -> None:
        """One charge on the cost meter.  Summing the `cost` fields of all
        billing records reconstructs `CostMeter.total`."""
        self._append({
            "type": REC_BILLING, "cost": cost, "duration_s": duration_s,
            "kind": kind, "client_id": client_id, "round": round_number,
        })

    def aggregation(self, *, time: float, round_number, merged: int,
                    strategy: str, mode: str, **extra) -> None:
        """One aggregation event (a round close, or an async merge).
        `extra` carries merge-pipeline metadata when a non-identity
        server optimizer is configured: `server_opt` (family name),
        `server_steps` (optimizer steps taken), and `update_norm`
        (‖Δ‖₂ of the pseudo-gradient; 0.0 for a zero-update merge)."""
        rec = {
            "type": REC_AGGREGATION, "time": time, "round": round_number,
            "merged": merged, "strategy": strategy, "mode": mode,
        }
        rec.update(extra)
        self._append(rec)

    def scheduling(self, *, time: float, round_number, scheduler: str,
                   mode: str, want: int, selected, pool_size: int,
                   **extra) -> None:
        """One Scheduler.propose() decision (fl/scheduler.py): a round
        cohort in barrier modes, a slot refill in barrier-free mode.
        `extra` carries scheduler-specific payload (tier counts for
        fedlesscan, score stats for apodotiko, cohort for adaptive)."""
        rec = {
            "type": REC_SCHEDULING, "time": time, "round": round_number,
            "scheduler": scheduler, "mode": mode, "want": want,
            "selected": list(selected), "pool_size": pool_size,
        }
        rec.update(extra)
        self._append(rec)

    def route(self, client_id: str, platform: str, reason: str) -> None:
        """A routing decision (fresh assignment or telemetry re-route)."""
        self._append({
            "type": REC_ROUTE, "client_id": client_id,
            "platform": platform, "reason": reason,
        })

    def on_plan(self, platform: str, plan, attempt: int) -> None:
        """Platform hook: a sampled invocation plan.  Feeds the cold-start
        telemetry window even for attempts that never produce an event
        (crash profiles)."""
        w = self._windows.setdefault(
            platform, deque(maxlen=self.telemetry_window))
        w.append((plan.failure is not None, plan.cold))

    def on_event(self, ev) -> None:
        """EventQueue hook: called for every popped event; records only
        the kinds in `event_kinds` (off by default)."""
        if ev.kind.value in self.event_kinds:
            self._append({
                "type": REC_EVENT, "time": ev.time, "kind": ev.kind.value,
                "client_id": ev.client_id, "round": ev.round_number,
            })

    # ---- streaming writer ---------------------------------------------
    def _shard_with_room(self) -> tuple:
        """(path, remaining capacity) of the shard to append to next."""
        if not self.shard_records:
            if not self._shards:
                self._shards = [self.stream_path]
                self._shard_counts = [0]
            return self._shards[0], _UNSHARDED_ROOM
        if (not self._shards
                or self._shard_counts[-1] >= self.shard_records):
            i = len(self._shards)
            p = self.stream_path.with_name(
                f"{self.stream_path.stem}.{i:05d}.jsonl")
            self._shards.append(p)
            self._shard_counts.append(0)
        return self._shards[-1], self.shard_records - self._shard_counts[-1]

    def flush(self) -> None:
        """Append the buffer to the stream file(s) and drop it — memory
        stays bounded regardless of trace length.  No-op when not
        streaming (the buffer IS the trace then)."""
        if self.stream_path is None or not self.records:
            return
        self.stream_path.parent.mkdir(parents=True, exist_ok=True)
        buf = self.records
        pos = 0
        while pos < len(buf):
            path, room = self._shard_with_room()
            take = buf[pos:pos + room]
            with path.open("a", encoding="utf-8") as fh:
                fh.writelines(_dump_line(r) for r in take)
            self._shard_counts[-1] += len(take)
            pos += len(take)
        self._flushed += len(buf)
        self.records = []

    def shard_paths(self) -> List[Path]:
        """Stream files written so far (one entry unless sharding)."""
        return list(self._shards)

    def _iter_lines(self) -> Iterator[str]:
        """Every record as its canonical JSONL line — flushed shards
        first, then the live buffer; never materializes the full trace."""
        for path in self._shards:
            with path.open("r", encoding="utf-8") as fh:
                yield from fh
        for rec in self.records:
            yield _dump_line(rec)

    def iter_records(self) -> Iterator[dict]:
        """Every record as a dict, in emission order, across both the
        flushed stream and the live buffer."""
        for path in self._shards:
            with path.open("r", encoding="utf-8") as fh:
                for line in fh:
                    if line.strip():
                        yield json.loads(line)
        yield from self.records

    # ---- checkpoint surface (fl/checkpointing.py) ---------------------
    def telemetry_state_dict(self) -> dict:
        """Snapshot the rolling per-platform windows (NOT the record
        stream: a resumed run writes its own trace, but telemetry-reactive
        routing must keep seeing the same recent failure/cold rates)."""
        return {name: [[bool(f), bool(c)] for f, c in w]
                for name, w in self._windows.items()}

    def load_telemetry_state(self, state: dict) -> None:
        self._windows = {
            name: deque(((bool(f), bool(c)) for f, c in obs),
                        maxlen=self.telemetry_window)
            for name, obs in state.items()}

    # ---- telemetry (read by TelemetryRoutingPolicy) -------------------
    def platform_stats(self) -> Dict[str, dict]:
        """Recent per-platform rates over the rolling window."""
        stats = {}
        for name, w in self._windows.items():
            n = len(w)
            failures = sum(1 for failed, _ in w if failed)
            colds = sum(1 for _, cold in w if cold)
            stats[name] = {
                "attempts": n,
                "failures": failures,
                "cold_starts": colds,
                "failure_rate": failures / n if n else 0.0,
                "cold_rate": colds / n if n else 0.0,
            }
        return stats

    # ---- export -------------------------------------------------------
    def select(self, record_type: str) -> List[dict]:
        if self._flushed:
            return [r for r in self.iter_records()
                    if r["type"] == record_type]
        return [r for r in self.records if r["type"] == record_type]

    def billed_total(self) -> float:
        """Reconstruct the meter total from the trace stream."""
        return sum(r["cost"] for r in self.select(REC_BILLING))

    def dumps(self) -> str:
        """The full trace as a JSONL string — byte-identical whether the
        recorder buffered or streamed."""
        if self._flushed:
            return "".join(self._iter_lines())
        return "".join(_dump_line(r) for r in self.records)

    def to_jsonl(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        if self._flushed:
            self.flush()
            with p.open("w", encoding="utf-8") as out:
                for line in self._iter_lines():
                    out.write(line)
        else:
            p.write_text(self.dumps())
        return p


def load_jsonl(path) -> List[dict]:
    """Round-trip loader for exported traces."""
    return [json.loads(line)
            for line in Path(path).read_text().splitlines() if line]
