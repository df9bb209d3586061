"""Client behavioural history — paper §V-A/§V-B, array-backed.

For every client we track the three attributes the paper collects
(training time, missed rounds, cooldown) plus invocation bookkeeping
used by the selection algorithm (Alg. 2) and the bias metric.

The cooldown follows Eq. 1 of the paper:

    cooldown = 0            if the client completed training in time
             = 1            on a miss when cooldown == 0
             = cooldown * 2 on a miss otherwise

Storage is a flat struct-of-arrays keyed by a stable
`ClientInterner` index (core/interning.py): cooldown, invocation /
success / failure counts, last round, and the training-time aggregates
(count, max) live in NumPy arrays so the selection hot path — tier
predicates over a million registered clients — is a handful of
vectorized mask operations instead of a Python loop.  The two genuinely
ragged attributes (the training-time list and the missed-round list)
live in sparse per-index dicts: they only exist for clients that were
actually invoked, so their footprint scales with activity, not with the
registered population.

`ClientRecord` remains available in two forms: the standalone dataclass
(directly constructible, used by unit tests and the scalar feature
reference) and the `ClientRecordView` that `ClientHistoryDB.get`
returns — a thin view over the arrays exposing the exact same
attributes and mutators, so every pre-existing call site keeps working.

Persistence is batched: mutations only set a dirty flag, and the JSON
snapshot is written on an explicit `save()` (or every `flush_every`
mutations when configured) — never once per event.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .interning import ClientInterner, grow_to

# Smoothing factor of the *maintained* training-time EMA column.  The
# incremental update replays the exact scalar `features.ema` recurrence
# (acc = α·x + (1−α)·acc, seeded by the first observation), so reading
# the column is bit-identical to recomputing the EMA from the ragged
# list — but O(1) per propose instead of O(history).
DEFAULT_EMA_ALPHA = 0.5

# Dense missed-round mirror: rows wider than this fall back to the
# ragged path (a client missing 64+ rounds is pathological; don't let it
# inflate the (N × W) matrix for the whole fleet).
_MISS_DENSE_CAP = 64


@dataclass
class ClientRecord:
    """Behavioural record for one client (one row of the history DB).

    Standalone dataclass form — `ClientHistoryDB` rows are
    `ClientRecordView`s sharing this exact interface."""

    client_id: str
    training_times: List[float] = field(default_factory=list)
    missed_rounds: List[int] = field(default_factory=list)
    cooldown: int = 0
    invocations: int = 0
    successes: int = 0
    failures: int = 0
    last_round: int = -1

    # ---- tiering predicates (paper §V-A) -------------------------------
    @property
    def is_rookie(self) -> bool:
        """Never produced behavioural data: no recorded time and no miss."""
        return not self.training_times and not self.missed_rounds

    @property
    def is_straggler(self) -> bool:
        """Cooldown > 0 characterises tier-3 stragglers (paper §V-B)."""
        return self.cooldown > 0 and not self.is_rookie

    @property
    def is_participant(self) -> bool:
        return not self.is_rookie and not self.is_straggler

    # ---- Eq. 1 ----------------------------------------------------------
    def apply_success(self) -> None:
        """Controller observed an in-time completion → cooldown = 0."""
        self.cooldown = 0
        self.successes += 1

    def apply_miss(self, round_number: int) -> None:
        """Controller observed a miss/failure for `round_number` (Eq. 1)."""
        if round_number not in self.missed_rounds:
            self.missed_rounds.append(round_number)
        self.cooldown = 1 if self.cooldown == 0 else self.cooldown * 2
        self.failures += 1

    def correct_missed_round(self, round_number: int) -> None:
        """Client-side correction (Alg. 1 lines 24-26): a slow-but-alive
        client that finished late deletes the round from its missed list —
        distinguishing *slow* from *crashed* happens on the client side."""
        if round_number in self.missed_rounds:
            self.missed_rounds.remove(round_number)

    def record_training_time(self, seconds: float) -> None:
        self.training_times.append(float(seconds))

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ClientRecord":
        return cls(**d)


class ClientRecordView:
    """`ClientRecord`-shaped view over one row of the array store."""

    __slots__ = ("_db", "_idx")

    def __init__(self, db: "ClientHistoryDB", idx: int):
        self._db = db
        self._idx = idx

    # ---- attributes ----------------------------------------------------
    @property
    def client_id(self) -> str:
        return self._db._interner.id_of(self._idx)

    @property
    def training_times(self) -> List[float]:
        return self._db._times.get(self._idx, [])

    @property
    def missed_rounds(self) -> List[int]:
        return self._db._missed.get(self._idx, [])

    @property
    def cooldown(self) -> int:
        return int(self._db._cooldown[self._idx])

    @cooldown.setter
    def cooldown(self, value: int) -> None:
        self._db._cooldown[self._idx] = int(value)
        self._db._sync_tier(self._idx)
        self._db._touch()

    @property
    def invocations(self) -> int:
        return int(self._db._invocations[self._idx])

    @invocations.setter
    def invocations(self, value: int) -> None:
        self._db._invocations[self._idx] = int(value)
        self._db._touch()

    @property
    def successes(self) -> int:
        return int(self._db._successes[self._idx])

    @successes.setter
    def successes(self, value: int) -> None:
        self._db._successes[self._idx] = int(value)
        self._db._touch()

    @property
    def failures(self) -> int:
        return int(self._db._failures[self._idx])

    @failures.setter
    def failures(self, value: int) -> None:
        self._db._failures[self._idx] = int(value)
        self._db._touch()

    @property
    def last_round(self) -> int:
        return int(self._db._last_round[self._idx])

    @last_round.setter
    def last_round(self, value: int) -> None:
        self._db._last_round[self._idx] = int(value)
        self._db._touch()

    # ---- tiering predicates -------------------------------------------
    @property
    def is_rookie(self) -> bool:
        db, i = self._db, self._idx
        return db._n_times[i] == 0 and db._n_missed[i] == 0

    @property
    def is_straggler(self) -> bool:
        return self._db._cooldown[self._idx] > 0 and not self.is_rookie

    @property
    def is_participant(self) -> bool:
        return not self.is_rookie and not self.is_straggler

    # ---- mutators (same semantics as the dataclass) --------------------
    def apply_success(self) -> None:
        db, i = self._db, self._idx
        db._cooldown[i] = 0
        db._successes[i] += 1
        db._sync_tier(i)
        db._touch()

    def apply_miss(self, round_number: int) -> None:
        self._db._apply_miss(self._idx, round_number)

    def correct_missed_round(self, round_number: int) -> None:
        self._db._correct_missed_round(self._idx, round_number)

    def record_training_time(self, seconds: float) -> None:
        self._db._record_time(self._idx, seconds)

    def to_dict(self) -> dict:
        return {"client_id": self.client_id,
                "training_times": list(self.training_times),
                "missed_rounds": list(self.missed_rounds),
                "cooldown": self.cooldown, "invocations": self.invocations,
                "successes": self.successes, "failures": self.failures,
                "last_round": self.last_round}

    def __repr__(self) -> str:       # debugging convenience
        return f"ClientRecordView({self.to_dict()!r})"


class ClientHistoryDB:
    """The `client history` collection the paper adds to the FedLess DB
    (§IV-A), as a flat array store.  Thread-safe because the simulated
    FaaS platform completes invocations concurrently."""

    def __init__(self, path: Optional[str] = None, flush_every: int = 0):
        self._interner = ClientInterner()
        self._lock = threading.RLock()
        self._path = Path(path) if path else None
        # batched persistence: write on save()/flush cadence, not per event
        self.flush_every = int(flush_every)
        self._dirty = False
        self._mutations = 0
        self._alloc(0)
        self._times: Dict[int, List[float]] = {}
        self._missed: Dict[int, List[int]] = {}
        if self._path and self._path.exists():
            self.load(self._path)

    def _alloc(self, n: int) -> None:
        self._cooldown = np.zeros(n, np.int64)
        self._invocations = np.zeros(n, np.int64)
        self._successes = np.zeros(n, np.int64)
        self._failures = np.zeros(n, np.int64)
        self._last_round = np.full(n, -1, np.int64)
        self._n_times = np.zeros(n, np.int64)
        self._n_missed = np.zeros(n, np.int64)
        self._t_max = np.zeros(n, np.float64)
        # maintained aggregates for the propose hot path: training-time
        # EMA (incremental, DEFAULT_EMA_ALPHA) and an inf-padded dense
        # mirror of the missed-round lists (kept because the missed-EMA
        # depends on current_round and must be recomputed per propose —
        # off the matrix instead of 10⁶ ragged lists)
        self._t_ema = np.zeros(n, np.float64)
        # float32 shadow of _t_ema, downcast at write time — fleet-scale
        # feature builds gather it directly instead of converting an
        # 8 MB float64 gather per propose (same values: double→float
        # rounding is deterministic wherever it happens)
        self._t_ema32 = np.zeros(n, np.float32)
        self._missed_mat = np.full((n, 0), np.inf, np.float64)
        self._dense_miss = True
        # maintained tier codes (0 rookie / 1 participant / 2 straggler):
        # the §V-A predicates only change when a row mutates, so they are
        # synced per mutation and tier_masks is three int8 compares
        # instead of three int64 gathers plus the predicate algebra
        self._tier = np.zeros(n, np.int8)
        self._iota = np.arange(n)       # cached identity, for is_full_pool
        self._full_pool_idx = None      # last idx verified as the identity

    def _grow(self, n: int) -> None:
        if n <= self._cooldown.shape[0]:
            return
        self._cooldown = grow_to(self._cooldown, n)
        self._invocations = grow_to(self._invocations, n)
        self._successes = grow_to(self._successes, n)
        self._failures = grow_to(self._failures, n)
        self._last_round = grow_to(self._last_round, n, fill=-1)
        self._n_times = grow_to(self._n_times, n)
        self._n_missed = grow_to(self._n_missed, n)
        self._t_max = grow_to(self._t_max, n, fill=0.0)
        self._t_ema = grow_to(self._t_ema, n, fill=0.0)
        self._t_ema32 = grow_to(self._t_ema32, n, fill=0.0)
        self._missed_mat = grow_to(self._missed_mat, n, fill=np.inf)
        self._tier = grow_to(self._tier, n)     # fresh rows default rookie
        if self._cooldown.shape[0] > self._iota.shape[0]:
            self._iota = np.arange(self._cooldown.shape[0])

    # ---- bookkeeping ---------------------------------------------------
    def _touch(self) -> None:
        self._dirty = True
        self._mutations += 1
        if (self.flush_every and self._path is not None
                and self._mutations >= self.flush_every):
            self.save()

    def _intern(self, client_id: str) -> int:
        idx = self._interner.intern(client_id)
        self._grow(len(self._interner))
        return idx

    @property
    def size(self) -> int:
        return len(self._interner)

    @property
    def interner(self) -> ClientInterner:
        return self._interner

    # ---- CRUD ----------------------------------------------------------
    def get(self, client_id: str) -> ClientRecordView:
        with self._lock:
            return ClientRecordView(self, self._intern(client_id))

    def all(self) -> List[ClientRecordView]:
        with self._lock:
            return [ClientRecordView(self, i) for i in range(self.size)]

    def ensure(self, client_ids: Iterable[str]) -> None:
        with self._lock:
            self._interner.intern_many(
                client_ids if hasattr(client_ids, "__len__")
                else list(client_ids))
            self._grow(len(self._interner))

    # ---- row mutations (shared with ClientRecordView) ------------------
    def _sync_tier(self, idx: int) -> None:
        """Re-derive one row's maintained tier code after a mutation —
        every code path that writes _n_times/_n_missed/_cooldown must
        call this (the golden-trace parity tests gate it)."""
        if self._n_times[idx] == 0 and self._n_missed[idx] == 0:
            self._tier[idx] = 0
        elif self._cooldown[idx] > 0:
            self._tier[idx] = 2
        else:
            self._tier[idx] = 1

    def rebuild_tiers(self) -> None:
        """Vectorized tier recompute over every row — for bulk loads and
        direct array seeding (benchmarks), where per-row syncs would be
        O(n) Python calls."""
        rookie = (self._n_times == 0) & (self._n_missed == 0)
        tier = np.ones(self._n_times.shape[0], np.int8)
        tier[rookie] = 0
        tier[(self._cooldown > 0) & ~rookie] = 2
        self._tier = tier

    def _apply_miss(self, idx: int, round_number: int) -> None:
        missed = self._missed.setdefault(idx, [])
        if round_number not in missed:
            missed.append(round_number)
            self._n_missed[idx] = len(missed)
            self._sync_missed_row(idx)
        cd = self._cooldown[idx]
        self._cooldown[idx] = 1 if cd == 0 else cd * 2
        self._failures[idx] += 1
        self._sync_tier(idx)
        self._touch()

    def _correct_missed_round(self, idx: int, round_number: int) -> None:
        missed = self._missed.get(idx)
        if missed and round_number in missed:
            missed.remove(round_number)
            self._n_missed[idx] = len(missed)
            self._sync_missed_row(idx)
            self._sync_tier(idx)
            self._touch()

    def _sync_missed_row(self, idx: int) -> None:
        """Mirror one client's missed-round list into the dense matrix
        (rewriting the W≤cap row is cheaper than bookkeeping order)."""
        row = self._missed.get(idx, [])
        n = len(row)
        width = self._missed_mat.shape[1]
        if n > width:
            if n > _MISS_DENSE_CAP:
                self._dense_miss = False
            else:
                new_w = min(_MISS_DENSE_CAP, max(n, 2 * width, 4))
                pad = np.full((self._missed_mat.shape[0], new_w - width),
                              np.inf, np.float64)
                self._missed_mat = np.concatenate(
                    (self._missed_mat, pad), axis=1)
        if self._dense_miss:
            self._missed_mat[idx, :] = np.inf
            if n:
                self._missed_mat[idx, :n] = row

    def _record_time(self, idx: int, seconds: float) -> None:
        seconds = float(seconds)
        self._times.setdefault(idx, []).append(seconds)
        # incremental EMA — same op sequence as features.ema, so reading
        # _t_ema is bit-identical to recomputing over the ragged list
        if self._n_times[idx] == 0:
            self._t_ema[idx] = seconds
        else:
            self._t_ema[idx] = (DEFAULT_EMA_ALPHA * seconds
                                + (1.0 - DEFAULT_EMA_ALPHA)
                                * self._t_ema[idx])
        self._t_ema32[idx] = self._t_ema[idx]
        self._n_times[idx] += 1
        if seconds > self._t_max[idx]:
            self._t_max[idx] = seconds
        self._sync_tier(idx)
        self._touch()

    # ---- controller-side updates (Alg. 1, lines 5-13) ------------------
    def mark_success(self, client_id: str, round_number: int) -> None:
        with self._lock:
            idx = self._intern(client_id)
            self._cooldown[idx] = 0
            self._successes[idx] += 1
            self._last_round[idx] = round_number
            self._invocations[idx] += 1
            self._sync_tier(idx)
            self._touch()

    def mark_miss(self, client_id: str, round_number: int) -> None:
        with self._lock:
            idx = self._intern(client_id)
            self._apply_miss(idx, round_number)
            self._last_round[idx] = round_number
            self._invocations[idx] += 1

    # ---- client-side updates (Alg. 1, lines 16-27) ----------------------
    def client_report(self, client_id: str, round_number: int,
                      training_time: float) -> None:
        """A (possibly late) client pushes its measured training time and
        corrects its missed-rounds entry for the current round."""
        with self._lock:
            idx = self._intern(client_id)
            self._record_time(idx, training_time)
            self._correct_missed_round(idx, round_number)

    # ---- vectorized surface (core/selection.py hot path) ---------------
    def indices_for(self, client_ids: Sequence[str]) -> np.ndarray:
        """Array-index view of a pool sequence (memoized per object)."""
        with self._lock:
            idx = self._interner.indices_for(client_ids)
            self._grow(len(self._interner))
            return idx

    def is_full_pool(self, idx: np.ndarray) -> bool:
        """True when `idx` is the identity permutation 0..len-1 — i.e. the
        caller's pool is every registered client in registration order
        (the common fleet-scale propose).  Lets hot paths substitute
        O(1) slice views for O(n) fancy-index copies.  The interner
        memoizes `indices_for` per pool object, so across proposes the
        same pool yields the *same* ndarray — a verified array is
        remembered by identity and re-verifies O(1).  (Callers never
        mutate pool index arrays; `select_clients` builds new arrays
        when it filters.)"""
        n = idx.size
        if n != len(self._interner) or n == 0:
            return False
        if idx is self._full_pool_idx:
            return True
        full = (idx[0] == 0 and idx[n - 1] == n - 1
                and bool((idx == self._iota[:n]).all()))
        if full:
            self._full_pool_idx = idx
        return full

    def tier_masks(self, idx: np.ndarray, full_pool=None):
        """Vectorized §V-A tier predicates over index array `idx`:
        returns (rookie, participant, straggler) boolean masks.  Reads
        the maintained int8 tier codes — identical truth values to
        evaluating the predicates, at an eighth of the memory traffic.
        Callers that already ran `is_full_pool` pass it as `full_pool`
        to skip the O(n) re-check."""
        if full_pool is None:
            full_pool = self.is_full_pool(idx)
        if full_pool:                   # slice view, no gather copy
            tier = self._tier[:idx.size]
        else:
            tier = self._tier[idx]
        return tier == 0, tier == 1, tier == 2

    def t_max_masked(self, mask: np.ndarray) -> float:
        """Max t_max over the store rows selected by boolean `mask` —
        the full-pool hot path's alternative to gathering a 10^6-row
        subset just to reduce it.  Identical value to
        `t_max_of(idx).max()` over the same rows.  Multiply-by-mask
        stands in for a `where=` reduction (which numpy runs ~2x
        slower): t_max is ≥ 0, so zeroing the unselected rows never
        raises the max, and an all-False mask yields the same 0.0 the
        `initial=` would."""
        if mask.shape[0] == 0:
            return 0.0
        return float(np.max(self._t_max[:mask.shape[0]] * mask))

    def invocations_of(self, idx: np.ndarray) -> np.ndarray:
        return self._invocations[idx]

    def t_max_of(self, idx: np.ndarray) -> np.ndarray:
        return self._t_max[idx]

    def ids_of(self, idx: np.ndarray) -> List[str]:
        ids = self._interner.ids
        return [ids[i] for i in idx]

    def ragged_times(self, idx: np.ndarray) -> List[List[float]]:
        times = self._times
        return [times.get(int(i), []) for i in idx]

    def ragged_missed(self, idx: np.ndarray) -> List[List[int]]:
        missed = self._missed
        return [missed.get(int(i), []) for i in idx]

    def t_ema_of(self, idx: np.ndarray,
                 alpha: float = DEFAULT_EMA_ALPHA,
                 dtype=np.float64):
        """Maintained training-time EMA rows — O(|idx|) gather, bit-equal
        to recomputing over the ragged lists.  Returns None when `alpha`
        differs from the maintained smoothing factor (callers fall back
        to the ragged recompute).  `dtype=float32` reads the downcast
        shadow column — identical values to casting the float64 gather,
        at half the traffic."""
        if alpha != DEFAULT_EMA_ALPHA:
            return None
        if dtype == np.float32:
            return self._t_ema32[idx]
        return self._t_ema[idx]

    def missed_matrix(self, idx: np.ndarray):
        """(values, lengths): dense inf-padded missed-round rows for
        `idx`, trimmed to the widest selected row.  `values` is a
        fancy-index copy — callers may sort it in place.  Returns None
        when some client overflowed the dense cap (ragged fallback)."""
        if not self._dense_miss:
            return None
        lengths = self._n_missed[idx]
        w = int(lengths.max()) if lengths.size else 0
        if w == 0:                      # no selected row missed anything
            return np.empty((idx.size, 0), np.float64), lengths
        return self._missed_mat[np.ix_(idx, np.arange(w))], lengths

    # ---- tier partition (paper §V-A) --------------------------------------
    def partition(self, client_ids: Iterable[str]):
        """Partition into (rookies, participants, stragglers) — pool
        order preserved, one vectorized predicate pass."""
        with self._lock:
            if not hasattr(client_ids, "__len__"):
                client_ids = list(client_ids)
            idx = self.indices_for(client_ids)
            rookie, participant, straggler = self.tier_masks(idx)
            view = ClientRecordView
            rookies = [view(self, int(i)) for i in idx[rookie]]
            participants = [view(self, int(i)) for i in idx[participant]]
            stragglers = [view(self, int(i)) for i in idx[straggler]]
        return rookies, participants, stragglers

    # ---- persistence -------------------------------------------------------
    def to_payload(self) -> dict:
        """JSON-ready snapshot of every record (the checkpoint surface:
        fl/checkpointing.py embeds it in the round-tagged driver state)."""
        with self._lock:
            return {cid: ClientRecordView(self, i).to_dict()
                    for i, cid in enumerate(self._interner.ids)}

    def load_payload(self, payload: dict) -> None:
        """Restore from a `to_payload()` snapshot, replacing all records."""
        with self._lock:
            self._interner = ClientInterner(list(payload))
            n = len(self._interner)
            self._alloc(n)
            self._grow(n)
            self._times, self._missed = {}, {}
            for i, d in enumerate(payload.values()):
                self._cooldown[i] = int(d.get("cooldown", 0))
                self._invocations[i] = int(d.get("invocations", 0))
                self._successes[i] = int(d.get("successes", 0))
                self._failures[i] = int(d.get("failures", 0))
                self._last_round[i] = int(d.get("last_round", -1))
                times = [float(t) for t in d.get("training_times", [])]
                missed = [int(m) for m in d.get("missed_rounds", [])]
                if times:
                    self._times[i] = times
                    self._n_times[i] = len(times)
                    self._t_max[i] = max(times)
                    acc = times[0]
                    for v in times[1:]:     # replay features.ema exactly
                        acc = (DEFAULT_EMA_ALPHA * v
                               + (1.0 - DEFAULT_EMA_ALPHA) * acc)
                    self._t_ema[i] = acc
                if missed:
                    self._missed[i] = missed
                    self._n_missed[i] = len(missed)
                    self._sync_missed_row(i)
            self._t_ema32 = self._t_ema.astype(np.float32)
            self.rebuild_tiers()
            self._dirty = True

    def save(self, path: Optional[str] = None, force: bool = False) -> None:
        """Write the JSON snapshot.  With the instance's own path and no
        pending mutations this is a no-op (the dirty flag makes repeated
        checkpoint-time saves O(1) instead of O(N) JSON dumps)."""
        p = Path(path) if path else self._path
        if p is None:
            raise ValueError("no persistence path configured")
        if p == self._path and not self._dirty and not force:
            return
        payload = self.to_payload()
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(payload))
        if p == self._path:
            self._dirty = False
            self._mutations = 0

    def load(self, path) -> None:
        self.load_payload(json.loads(Path(path).read_text()))
        self._dirty = False
        self._mutations = 0
