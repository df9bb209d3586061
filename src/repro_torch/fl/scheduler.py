"""Unified client-scheduling subsystem — every cohort decision in one place.

A `Scheduler` owns all client picking and the `TrainingDriver` consumes
one uniform surface in every mode:

* ``propose(pool, want, now, round_number, exclude=frozenset())`` —
  pick the next cohort (sync round cohorts, semi-async refills, and
  single-slot async rotation refills all go through this call).  The
  driver passes the *full* population plus an ``exclude`` set of
  in-flight clients, so no O(N) filtered pool list is materialized per
  refill; schedulers resolve exclusion against their interning tables
  as a vectorized mask.  Legacy schedulers without the ``exclude``
  parameter still get a pre-filtered pool (the driver sniffs the
  signature once).
* ``notify_finish`` / ``notify_miss`` — the driver's feedback channel:
  every observed completion, miss, or crash is reported back so
  behaviour-aware schedulers can adapt;
* ``cohort_size(round_number, telemetry)`` — how many clients the next
  round should invoke, given trailing `RoundStats` telemetry (the
  adaptive-sizing hook).

Shipped policies (``make_scheduler``):

``random``      uniform sampling (FedAvg/FedProx behaviour);
``fedlesscan``  the paper's Algorithm 2 tier selection (rookies →
                DBSCAN-clustered participants → stragglers), wrapping
                ``core.selection.select_clients``;
``apodotiko``   score-based probabilistic sampling (arXiv 2404.14033):
                a per-client score combining duration EMA, success
                rate, cold-start rate, and selection staleness feeds a
                softmax whose temperature anneals over rounds —
                explore early, exploit reliable clients late;
``adaptive``    cohort sizing driven by trailing EUR / straggler ratio
                (grow the cohort while updates land, shrink it while
                slots are being wasted), selection delegated to an
                inner scheduler;
``rotation``    the barrier-free driver's default: deterministic cyclic
                rotation with exponential (virtual-time) failure
                backoff.

Fleet scale: every per-client tally lives in a flat NumPy array keyed
by a `ClientInterner` index (core/interning.py) — Apodotiko scoring is
a handful of masked array expressions plus one weighted `rng.choice`,
and the rotation scan is a vectorized pass over the rolled order array.
The array paths replay the *exact* float op sequence and RNG stream of
the historical dict implementation, so same-seed cohorts are
byte-identical (gated by tests/test_fleet_scale.py golden traces).

Strategies keep working unchanged: ``Strategy.select`` is a shim that
delegates to the strategy's own scheduler (random for FedAvg-like
strategies, Algorithm 2 for FedLesScan, whole-pool for SAFA).
`state_dict`/`load_state_dict` round-trip scheduler state for the
round-tagged checkpoint/resume path (fl/checkpointing.py).
"""
from __future__ import annotations

import inspect
from typing import List, Optional, Sequence

import numpy as np

from ..core.features import ema_step, normalize01
from ..core.history import ClientHistoryDB
from ..core.interning import ClientInterner, grow_to
from ..core.selection import SelectionPlan, select_clients, select_random
from .metrics import TrailingMetricsCache

EMPTY = frozenset()

# pool size beyond which Apodotiko scoring switches to float32 passes —
# far above any byte-parity-gated run, so small-fleet cohorts stay
# bit-identical to the float64 reference
_SCORE_F32_MIN = 1 << 18


def _rng_state(rng: np.random.Generator) -> dict:
    return rng.bit_generator.state


def _set_rng_state(rng: np.random.Generator, state) -> None:
    # JSON round-trips tuple-typed entries as lists; numpy accepts dicts
    rng.bit_generator.state = state


def scheduler_supports_exclude(scheduler) -> bool:
    """Does `scheduler.propose` accept the `exclude` kwarg?  Legacy
    subclasses with the four-argument signature get the pre-filtered
    pool instead (the driver checks once, not per call)."""
    try:
        params = inspect.signature(scheduler.propose).parameters
    except (TypeError, ValueError):
        return False
    return ("exclude" in params
            or any(p.kind is p.VAR_KEYWORD for p in params.values()))


def _excluded_mask(interner: ClientInterner, pool_idx: np.ndarray,
                   exclude) -> Optional[np.ndarray]:
    """Boolean keep-mask over `pool_idx` (None = keep everything)."""
    if not exclude:
        return None
    lookup = interner.lookup
    ex = np.fromiter((lookup(c) for c in exclude), np.int64, len(exclude))
    ex = ex[ex >= 0]
    if ex.size == 0:
        return None
    return ~np.isin(pool_idx, ex)


class _ArrayMap:
    """Dict-like view over one per-client tally array.

    The array-backed schedulers store tallies as flat arrays; this view
    keeps the historical ``{client_id: value}`` read/write surface alive
    for tests and debugging.  An entry "exists" when its value differs
    from the column default (or when its paired seen-flag is set)."""

    __slots__ = ("_sched", "_attr", "_default", "_cast", "_seen_attr",
                 "_always")

    def __init__(self, sched, attr: str, default, cast, seen_attr=None,
                 always_present=False):
        self._sched = sched
        self._attr = attr
        self._default = default
        self._cast = cast
        self._seen_attr = seen_attr
        self._always = always_present

    def _present(self, i: int) -> bool:
        if self._always:
            return True
        if self._seen_attr is not None:
            return bool(getattr(self._sched, self._seen_attr)[i])
        return getattr(self._sched, self._attr)[i] != self._default

    def __getitem__(self, client_id: str):
        i = self._sched._interner.lookup(client_id)
        if i < 0 or not self._present(i):
            raise KeyError(client_id)
        return self._cast(getattr(self._sched, self._attr)[i])

    def get(self, client_id: str, default=None):
        try:
            return self[client_id]
        except KeyError:
            return default

    def __setitem__(self, client_id: str, value) -> None:
        i = self._sched._intern(client_id)
        getattr(self._sched, self._attr)[i] = value
        if self._seen_attr is not None:
            getattr(self._sched, self._seen_attr)[i] = True
        sync = getattr(self._sched, "_sync_rates", None)
        if sync is not None:            # keep derived mirrors coherent
            sync(i)

    def __contains__(self, client_id: str) -> bool:
        i = self._sched._interner.lookup(client_id)
        return i >= 0 and self._present(i)

    def _indices(self):
        return [i for i in range(len(self._sched._interner))
                if self._present(i)]

    def __iter__(self):
        ids = self._sched._interner.ids
        return iter([ids[i] for i in self._indices()])

    def __len__(self) -> int:
        return len(self._indices())

    def keys(self):
        return list(self)

    def values(self):
        arr = getattr(self._sched, self._attr)
        return [self._cast(arr[i]) for i in self._indices()]

    def items(self):
        ids = self._sched._interner.ids
        arr = getattr(self._sched, self._attr)
        return [(ids[i], self._cast(arr[i])) for i in self._indices()]


class Scheduler:
    """Base class: owns the RNG and the default (fixed) cohort size."""

    name = "base"

    def __init__(self, clients_per_round: int,
                 rng: Optional[np.random.Generator] = None, seed: int = 0):
        self.clients_per_round = clients_per_round
        self.rng = rng if rng is not None else np.random.default_rng(seed)

    # ---- the three-call protocol the TrainingDriver consumes ----------
    def propose(self, pool: Sequence[str], want: int, now: float,
                round_number: int, exclude=EMPTY) -> List[str]:
        """Pick up to `want` clients from `pool` minus `exclude` (the
        in-flight set; empty in barrier modes where the driver proposes
        whole cohorts at round start)."""
        raise NotImplementedError

    def notify_finish(self, client_id: str, now: float,
                      duration_s: float = 0.0, cold: bool = False,
                      late: bool = False) -> None:
        """A client's update physically arrived (possibly late)."""

    def notify_miss(self, client_id: str, now: float,
                    crashed: bool = True) -> None:
        """A client missed: `crashed` distinguishes terminal failures /
        unresponsive clients from merely-late or never-started ones."""

    def cohort_size(self, round_number: int, telemetry: Sequence) -> int:
        """How many clients the next round should invoke.  `telemetry`
        is the driver's trailing `RoundStats` window (may be empty)."""
        return self.clients_per_round

    # ---- trace + checkpoint surfaces ----------------------------------
    def decision_info(self) -> dict:
        """Extra payload for the last propose()'s `scheduling` record."""
        return {}

    def state_dict(self) -> dict:
        return {"rng": _rng_state(self.rng)}

    def load_state_dict(self, state: dict) -> None:
        if "rng" in state:
            _set_rng_state(self.rng, state["rng"])


class RandomScheduler(Scheduler):
    """Uniform random cohorts — FedAvg/FedProx selection."""

    name = "random"

    def __init__(self, clients_per_round: int,
                 rng: Optional[np.random.Generator] = None, seed: int = 0):
        super().__init__(clients_per_round, rng=rng, seed=seed)
        self._interner = ClientInterner()

    def propose(self, pool, want, now, round_number, exclude=EMPTY):
        if not exclude:
            return select_random(pool, want, self.rng)
        if not hasattr(pool, "__len__"):
            pool = list(pool)
        keep = _excluded_mask(self._interner,
                              self._interner.indices_for(pool), exclude)
        if keep is None:
            return select_random(pool, want, self.rng)
        positions = np.flatnonzero(keep)
        k = min(want, positions.size)
        pos = self.rng.choice(positions.size, size=k, replace=False)
        return [pool[int(i)] for i in positions[pos]]


class StrategySelectScheduler(Scheduler):
    """Adapter for legacy Strategy subclasses that override `select`
    directly (pre-scheduler API): `propose` calls the override, so a
    hand-written selection policy keeps winning over the strategy's
    default scheduler when the driver picks its cohorts.  Keeps the
    legacy four-argument signature — the driver pre-filters the pool."""

    name = "strategy-select"

    def __init__(self, strategy):
        super().__init__(strategy.config.clients_per_round,
                         rng=strategy.rng)
        self.strategy = strategy

    def propose(self, pool, want, now, round_number):
        return self.strategy.select(pool, round_number)


class FullPoolScheduler(Scheduler):
    """SAFA-style: invoke every eligible client, ignore `want` (the
    round then closes at the strategy's quorum)."""

    name = "full"

    def propose(self, pool, want, now, round_number, exclude=EMPTY):
        if exclude:
            return [c for c in pool if c not in exclude]
        return list(pool)


class FedLesScanScheduler(Scheduler):
    """Paper Algorithm 2 — tier selection over the behavioural history
    (rookies → clustered participants → stragglers)."""

    name = "fedlesscan"

    def __init__(self, clients_per_round: int, history: ClientHistoryDB,
                 max_rounds: int = 50, ema_alpha: float = 0.5,
                 rng: Optional[np.random.Generator] = None, seed: int = 0):
        super().__init__(clients_per_round, rng=rng, seed=seed)
        self.history = history
        self.max_rounds = max_rounds
        self.ema_alpha = ema_alpha
        self.last_plan: Optional[SelectionPlan] = None

    def propose(self, pool, want, now, round_number, exclude=EMPTY):
        plan = select_clients(self.history, pool, round_number,
                              self.max_rounds, want, self.rng,
                              ema_alpha=self.ema_alpha, exclude=exclude)
        self.last_plan = plan
        return plan.selected

    def decision_info(self):
        p = self.last_plan
        if p is None:
            return {}
        return {"rookies": len(p.rookies),
                "clustered": len(p.cluster_clients),
                "stragglers": len(p.straggler_clients),
                "n_clusters": p.n_clusters, "eps": p.eps}


class ApodotikoScheduler(Scheduler):
    """Score-based probabilistic sampling (Apodotiko, arXiv 2404.14033).

    Each client gets a score in [0, 1] from four behavioural terms::

        score = w_dur  · (1 − norm(durationEMA))     fast clients up
              + w_succ · successRate                  reliable clients up
              + w_cold · (1 − coldStartRate)          warm clients up
              + w_stale· norm(roundsSinceSelected)    ignored clients up

    Unseen clients score 1.0 (maximum) so every client is explored
    before the policy starts discriminating.  The cohort is sampled
    without replacement from ``softmax(score / T)`` with the temperature
    annealed geometrically over rounds (``T = max(T_min, T0·decay^t)``)
    — early rounds explore broadly, late rounds concentrate on the
    clients that kept delivering.

    All behavioural tallies are flat arrays over the scheduler's own
    interning table; one propose at 10⁶ clients is a few masked array
    expressions plus a single weighted sample.
    """

    name = "apodotiko"

    def __init__(self, clients_per_round: int,
                 rng: Optional[np.random.Generator] = None, seed: int = 0, *,
                 ema_alpha: float = 0.5, temperature: float = 0.35,
                 temperature_decay: float = 0.9,
                 min_temperature: float = 0.05,
                 w_duration: float = 0.3, w_success: float = 0.4,
                 w_cold: float = 0.1, w_staleness: float = 0.2):
        super().__init__(clients_per_round, rng=rng, seed=seed)
        self.ema_alpha = ema_alpha
        self.temperature = temperature
        self.temperature_decay = temperature_decay
        self.min_temperature = min_temperature
        self.weights = (w_duration, w_success, w_cold, w_staleness)
        # behavioural tallies, fed exclusively by the notify hooks
        self._interner = ClientInterner()
        self._alloc(0)
        self._last_stats: Optional[dict] = None

    def _alloc(self, n: int) -> None:
        self._dur = np.zeros(n, np.float64)       # duration EMA
        self._seen = np.zeros(n, bool)            # has a duration EMA
        self._obs = np.zeros(n, np.int64)         # resolved invocations
        self._succ = np.zeros(n, np.int64)
        self._fin = np.zeros(n, np.int64)         # cold-rate denominator
        self._cold = np.zeros(n, np.int64)
        self._last_sel = np.full(n, -1, np.int64)
        # derived float32 mirrors for the fleet-scale scoring path —
        # maintained per event (O(1)), rebuilt wholesale on state load,
        # never checkpointed.  Defaults match the scoring identities:
        # success rate 1 while unobserved, cold rate 0 while unfinished.
        self._dur32 = np.zeros(n, np.float32)
        self._rate_succ = np.ones(n, np.float32)
        self._rate_cold = np.zeros(n, np.float32)
        self._iota = np.arange(n)

    def _capacity(self) -> None:
        n = len(self._interner)
        if n > self._dur.shape[0]:
            self._dur = grow_to(self._dur, n, fill=0.0)
            self._seen = grow_to(self._seen, n, fill=False)
            self._obs = grow_to(self._obs, n)
            self._succ = grow_to(self._succ, n)
            self._fin = grow_to(self._fin, n)
            self._cold = grow_to(self._cold, n)
            self._last_sel = grow_to(self._last_sel, n, fill=-1)
            self._dur32 = grow_to(self._dur32, n, fill=0.0)
            self._rate_succ = grow_to(self._rate_succ, n, fill=1.0)
            self._rate_cold = grow_to(self._rate_cold, n, fill=0.0)
            if self._dur.shape[0] > self._iota.shape[0]:
                self._iota = np.arange(self._dur.shape[0])

    def _intern(self, client_id: str) -> int:
        i = self._interner.intern(client_id)
        self._capacity()
        return i

    # ---- feedback -----------------------------------------------------
    def notify_finish(self, client_id, now, duration_s=0.0, cold=False,
                      late=False):
        i = self._intern(client_id)
        # a late arrival is the second half of an invocation the deadline
        # already reported through notify_miss — it contributes duration /
        # cold-start data but not a second resolved-invocation observation
        # (else chronic-but-productive stragglers are double-penalized)
        if not late:
            self._obs[i] += 1
            self._succ[i] += 1
        self._fin[i] += 1
        if cold:
            self._cold[i] += 1
        prev = float(self._dur[i]) if self._seen[i] else None
        self._dur[i] = ema_step(prev, duration_s, self.ema_alpha)
        self._seen[i] = True
        self._sync_rates(i)

    def notify_miss(self, client_id, now, crashed=True):
        i = self._intern(client_id)     # intern first: it may grow _obs
        self._obs[i] += 1
        self._sync_rates(i)

    def _sync_rates(self, i: int) -> None:
        """Refresh one row of the float32 scoring mirrors (same rounding
        as casting the int-tally divisions, so the mirror path scores
        exactly what the on-the-fly float32 path would)."""
        self._dur32[i] = self._dur[i]
        obs = self._obs[i]
        if obs > 0:
            self._rate_succ[i] = self._succ[i] / obs
        fin = self._fin[i]
        if fin > 0:
            self._rate_cold[i] = self._cold[i] / fin

    def _rebuild_rates(self) -> None:
        """Vectorized mirror rebuild after a bulk state load."""
        self._dur32 = self._dur.astype(np.float32)
        n = self._dur.shape[0]
        rs = np.ones(n, np.float32)
        np.divide(self._succ, self._obs, out=rs, where=self._obs > 0)
        rc = np.zeros(n, np.float32)
        np.divide(self._cold, self._fin, out=rc, where=self._fin > 0)
        self._rate_succ, self._rate_cold = rs, rc

    # ---- dict-like views (historical debug/test surface) --------------
    @property
    def _duration_ema(self):
        return _ArrayMap(self, "_dur", 0.0, float, seen_attr="_seen")

    @property
    def _observations(self):
        return _ArrayMap(self, "_obs", 0, int)

    @property
    def _successes(self):
        return _ArrayMap(self, "_succ", 0, int)

    @property
    def _finishes(self):
        return _ArrayMap(self, "_fin", 0, int)

    @property
    def _cold_starts(self):
        return _ArrayMap(self, "_cold", 0, int)

    @property
    def _last_selected(self):
        return _ArrayMap(self, "_last_sel", -1, int)

    # ---- scoring ------------------------------------------------------
    def _scores(self, idx, round_number: int) -> np.ndarray:
        if not isinstance(idx, np.ndarray):       # id sequence (tests)
            idx = self._interner.indices_for(list(idx))
            self._capacity()
        n = idx.size
        if n > _SCORE_F32_MIN:
            return self._scores_f32(idx, round_number)
        w_dur, w_succ, w_cold, w_stale = self.weights
        seen, dur = self._seen[idx], self._dur[idx]
        n_succ, obs = self._succ[idx], self._obs[idx]
        fin, n_cold = self._fin[idx], self._cold[idx]
        last = self._last_sel[idx]
        dur_norm = normalize01(dur, mask=seen)
        succ = np.ones(n, np.float64)
        np.divide(n_succ, obs, out=succ, where=obs > 0)
        cold = np.zeros(n, np.float64)
        np.divide(n_cold, fin, out=cold, where=fin > 0)
        stale_norm = normalize01((round_number - last).astype(np.float64))
        # same left-associative sum as the spelled-out expression, built
        # in place to avoid a chain of n-sized temporaries
        scores = 1.0 - dur_norm
        scores *= w_dur
        succ *= w_succ
        scores += succ
        np.subtract(1.0, cold, out=cold)
        cold *= w_cold
        scores += cold
        stale_norm *= w_stale
        scores += stale_norm
        # rookies (never resolved): maximum score — explore them first
        scores[obs == 0] = 1.0
        return scores

    def _scores_f32(self, idx: np.ndarray, round_number: int) -> np.ndarray:
        """Fleet-scale scoring: float32 passes over the maintained
        mirrors, slice views when the pool is the whole registry.  Scores
        only rank clients for a softmax draw, so float32 precision is
        immaterial; small fleets never reach this path, keeping the
        byte-parity float64 behaviour."""
        w_dur, w_succ, w_cold, w_stale = self.weights
        n = idx.size
        if (n == len(self._interner) and n > 0 and idx[0] == 0
                and idx[n - 1] == n - 1
                and bool((idx == self._iota[:n]).all())):
            seen = self._seen[:n]
            dur32, obs = self._dur32[:n], self._obs[:n]
            succ_rate, cold_rate = self._rate_succ[:n], self._rate_cold[:n]
            last = self._last_sel[:n]
        else:
            seen = self._seen[idx]
            dur32, obs = self._dur32[idx], self._obs[idx]
            succ_rate, cold_rate = self._rate_succ[idx], self._rate_cold[idx]
            last = self._last_sel[idx]
        dur_norm = normalize01(dur32, mask=seen, dtype=np.float32)
        stale_norm = normalize01(round_number - last.astype(np.float32),
                                 dtype=np.float32)
        # left-associative weighted sum, in place; the mirrors are store
        # state so every term that touches them makes a fresh array first
        scores = 1.0 - dur_norm
        scores *= w_dur
        scores += succ_rate * np.float32(w_succ)
        tmp = 1.0 - cold_rate
        tmp *= w_cold
        scores += tmp
        stale_norm *= w_stale
        scores += stale_norm
        scores[obs == 0] = 1.0      # rookies: maximum score, explore first
        return scores

    def propose(self, pool, want, now, round_number, exclude=EMPTY):
        if not hasattr(pool, "__len__"):
            pool = list(pool)
        pool_idx = self._interner.indices_for(pool)
        self._capacity()
        keep = _excluded_mask(self._interner, pool_idx, exclude)
        if keep is None:
            idx, positions = pool_idx, None
        else:
            idx, positions = pool_idx[keep], np.flatnonzero(keep)
        k = min(want, idx.size)
        if k <= 0:
            return []
        scores = self._scores(idx, round_number)
        t = max(self.min_temperature,
                self.temperature * self.temperature_decay ** round_number)
        logits = scores / t
        logits -= logits.max()
        probs = np.exp(logits, out=logits)      # same values, no n-temp
        if probs.dtype != np.float64:           # float32 scoring path:
            probs = probs.astype(np.float64)    # Generator.choice checks
        probs /= probs.sum()                    # sum(p)=1 in float64
        pos = self.rng.choice(idx.size, size=k, replace=False, p=probs)
        self._last_sel[idx[pos]] = round_number
        self._last_stats = {"score_min": float(scores.min()),
                            "score_max": float(scores.max()),
                            "score_mean": float(scores.mean())}
        if positions is not None:
            pos = positions[pos]
        return [pool[int(i)] for i in pos]

    def decision_info(self):
        return dict(self._last_stats) if self._last_stats else {}

    # ---- checkpoint surface (JSON shape matches the dict-era state) ---
    def _emit(self, array: np.ndarray, mask: np.ndarray, cast) -> dict:
        ids = self._interner.ids
        return {ids[i]: cast(array[i]) for i in np.flatnonzero(mask)}

    def state_dict(self):
        state = super().state_dict()
        n = len(self._interner)
        sl = slice(0, n)
        state.update(
            duration_ema=self._emit(self._dur, self._seen[sl], float),
            observations=self._emit(self._obs, self._obs[sl] > 0, int),
            successes=self._emit(self._succ, self._succ[sl] > 0, int),
            finishes=self._emit(self._fin, self._fin[sl] > 0, int),
            cold_starts=self._emit(self._cold, self._cold[sl] > 0, int),
            last_selected=self._emit(self._last_sel,
                                     self._last_sel[sl] >= 0, int))
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        fields = (("duration_ema", "_dur"), ("observations", "_obs"),
                  ("successes", "_succ"), ("finishes", "_fin"),
                  ("cold_starts", "_cold"), ("last_selected", "_last_sel"))
        self._interner = ClientInterner()
        for key, _ in fields:
            self._interner.intern_many(list(state.get(key, {})))
        self._alloc(0)
        self._capacity()
        for key, attr in fields:
            arr = getattr(self, attr)
            for cid, val in state.get(key, {}).items():
                arr[self._interner.index_of(cid)] = val
        for cid in state.get("duration_ema", {}):
            self._seen[self._interner.index_of(cid)] = True
        self._rebuild_rates()


class AdaptiveScheduler(Scheduler):
    """Adaptive cohort sizing over an inner selection policy.

    Reads the trailing `RoundStats` window: while the effective update
    ratio stays high (slots are not being wasted) the cohort grows one
    client per round toward `max_cohort`; when EUR drops or the
    straggler ratio spikes it shrinks toward `min_cohort` — spending
    invocations where they convert into updates.  The trailing metrics
    are memoized on the window's identity (`TrailingMetricsCache`), so
    repeated `cohort_size` calls against an unchanged telemetry window
    don't recompute them.
    """

    name = "adaptive"

    def __init__(self, clients_per_round: int,
                 rng: Optional[np.random.Generator] = None, seed: int = 0, *,
                 inner: Optional[Scheduler] = None,
                 min_cohort: Optional[int] = None,
                 max_cohort: Optional[int] = None, low_eur: float = 0.6,
                 high_eur: float = 0.95, straggler_cap: float = 0.4,
                 window: int = 3):
        super().__init__(clients_per_round, rng=rng, seed=seed)
        self.inner = inner or RandomScheduler(clients_per_round, rng=self.rng)
        self._inner_excludes = scheduler_supports_exclude(self.inner)
        self.min_cohort = (min_cohort if min_cohort is not None
                           else max(2, clients_per_round // 2))
        self.max_cohort = max_cohort or 2 * clients_per_round
        self.low_eur = low_eur
        self.high_eur = high_eur
        self.straggler_cap = straggler_cap
        self.window = window
        self._trailing = TrailingMetricsCache(window)
        self._size = clients_per_round

    def cohort_size(self, round_number, telemetry):
        if telemetry:
            eur, straggling = self._trailing.compute(telemetry)
            if eur <= self.low_eur or straggling >= self.straggler_cap:
                self._size = max(self.min_cohort, self._size - 1)
            elif eur >= self.high_eur:
                self._size = min(self.max_cohort, self._size + 1)
        return self._size

    def propose(self, pool, want, now, round_number, exclude=EMPTY):
        if self._inner_excludes:
            return self.inner.propose(pool, want, now, round_number,
                                      exclude=exclude)
        if exclude:
            pool = [c for c in pool if c not in exclude]
        return self.inner.propose(pool, want, now, round_number)

    def notify_finish(self, client_id, now, **kwargs):
        self.inner.notify_finish(client_id, now, **kwargs)

    def notify_miss(self, client_id, now, crashed=True):
        self.inner.notify_miss(client_id, now, crashed=crashed)

    def decision_info(self):
        info = {"cohort": self._size}
        info.update(self.inner.decision_info())
        return info

    def state_dict(self):
        state = super().state_dict()
        state["size"] = self._size
        state["inner"] = self.inner.state_dict()
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self._size = int(state.get("size", self._size))
        self.inner.load_state_dict(state.get("inner", {}))


class RotationScheduler(Scheduler):
    """Barrier-free rotation — the async driver's default policy.

    Deterministic cyclic rotation over the whole population, skipping
    clients outside the eligible pool (in flight) and clients in
    failure backoff; when every eligible client is cooling down, the
    first one is probed anyway.  A crashed/failing client's cooldown
    doubles per consecutive failure (the async twin of the paper's
    Eq. 1) and resets when an update of theirs finally arrives.

    The rotation is an index array plus a cursor; each pick is one
    vectorized scan over the rolled order (semantically identical to
    the historical deque walk, including cursor advancement: the
    cursor moves one slot per inspected client, and a full fruitless
    scan leaves it in place).
    """

    name = "rotation"

    def __init__(self, clients_per_round: int, client_ids: Sequence[str],
                 timeout_s: float = 120.0,
                 rng: Optional[np.random.Generator] = None, seed: int = 0):
        super().__init__(clients_per_round, rng=rng, seed=seed)
        self.timeout_s = timeout_s
        self._interner = ClientInterner()
        self._set_rotation(list(client_ids))

    def _set_rotation(self, client_ids: Sequence[str]) -> None:
        self._order = self._interner.intern_many(client_ids)
        self._cursor = 0
        n = len(self._interner)
        self._streak = np.zeros(n, np.int64)
        self._cool = np.zeros(n, np.float64)

    def _capacity(self) -> None:
        n = len(self._interner)
        if n > self._streak.shape[0]:
            self._streak = grow_to(self._streak, n)
            self._cool = grow_to(self._cool, n, fill=0.0)

    def _intern(self, client_id: str) -> int:
        i = self._interner.intern(client_id)
        self._capacity()
        return i

    # ---- dict-like views (historical debug/test surface) --------------
    @property
    def _fail_streak(self):
        return _ArrayMap(self, "_streak", 0, int, always_present=True)

    @property
    def _cooldown_until(self):
        return _ArrayMap(self, "_cool", 0.0, float)

    def _next(self, elig: np.ndarray, now: float) -> Optional[int]:
        order, c = self._order, self._cursor
        n = order.size
        rolled = np.concatenate((order[c:], order[:c]))
        emask = elig[rolled]
        ready = emask & (self._cool[rolled] <= now)
        if ready.any():
            j = int(ready.argmax())
            self._cursor = (c + j + 1) % n      # one rotation per inspection
            return int(rolled[j])
        if emask.any():
            # everyone eligible is cooling down: probe the first anyway
            # (a full scan happened — the cursor ends where it started)
            return int(rolled[int(emask.argmax())])
        return None

    def propose(self, pool, want, now, round_number, exclude=EMPTY):
        if self._order.size == 0 or want <= 0:
            return []
        if not hasattr(pool, "__len__"):
            pool = list(pool)
        pool_idx = self._interner.indices_for(pool)
        self._capacity()
        elig = np.zeros(len(self._interner), bool)
        elig[pool_idx] = True
        if exclude:
            lookup = self._interner.lookup
            for cid in exclude:
                i = lookup(cid)
                if i >= 0:
                    elig[i] = False
        # One vectorized pass builds the order-space candidate sets; each
        # pick is then a binary search from the cursor instead of an
        # O(n) roll per pick (`_next`), with identical semantics: `used`
        # holds this propose's picks, and skipping them costs at most
        # `want` steps since candidate arrays are sorted.
        order = self._order
        n = order.size
        emask = elig[order]
        ready_pos = np.flatnonzero(emask & (self._cool[order] <= now))
        elig_pos = np.flatnonzero(emask)
        used: set = set()

        def first_from(pos: np.ndarray, c: int) -> Optional[int]:
            m = pos.size
            if m == 0:
                return None
            j = int(np.searchsorted(pos, c))
            for k in range(m):
                p = int(pos[(j + k) % m])
                if p not in used:
                    return p
            return None

        ids = self._interner.ids
        out: List[str] = []
        for _ in range(want):
            p = first_from(ready_pos, self._cursor)
            if p is not None:
                self._cursor = (p + 1) % n    # one rotation per inspection
            else:
                # everyone eligible is cooling down: probe the first
                # anyway (full fruitless scan — cursor stays put)
                p = first_from(elig_pos, self._cursor)
                if p is None:
                    break
            used.add(p)
            out.append(ids[int(order[p])])
        return out

    def notify_finish(self, client_id, now, duration_s=0.0, cold=False,
                      late=False):
        i = self._intern(client_id)
        self._streak[i] = 0
        self._cool[i] = 0.0

    def notify_miss(self, client_id, now, crashed=True):
        if not crashed:
            return      # late-but-alive clients are not penalized
        i = self._intern(client_id)
        streak = int(self._streak[i]) + 1
        self._streak[i] = streak
        self._cool[i] = now + self.timeout_s * 2.0 ** (streak - 1)

    def state_dict(self):
        state = super().state_dict()
        order = np.concatenate((self._order[self._cursor:],
                                self._order[:self._cursor]))
        ids = self._interner.ids
        n = len(ids)
        state.update(
            rotation=[ids[i] for i in order],
            fail_streak={ids[i]: int(self._streak[i])
                         for i in np.flatnonzero(self._streak[:n] > 0)},
            cooldown_until={ids[i]: float(self._cool[i])
                            for i in np.flatnonzero(self._cool[:n] > 0.0)})
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        if "rotation" in state:
            self._set_rotation(list(state["rotation"]))
        else:
            self._streak[:] = 0
            self._cool[:] = 0.0
        for cid, streak in state.get("fail_streak", {}).items():
            self._streak[self._intern(cid)] = int(streak)
        for cid, until in state.get("cooldown_until", {}).items():
            self._cool[self._intern(cid)] = float(until)


SCHEDULERS = {cls.name: cls for cls in
              (RandomScheduler, FullPoolScheduler, FedLesScanScheduler,
               ApodotikoScheduler, AdaptiveScheduler, RotationScheduler)}


def make_scheduler(name: str, clients_per_round: int, *,
                   history: Optional[ClientHistoryDB] = None,
                   max_rounds: int = 50, ema_alpha: float = 0.5,
                   client_ids: Optional[Sequence[str]] = None,
                   timeout_s: float = 120.0,
                   rng: Optional[np.random.Generator] = None,
                   seed: int = 0, **kwargs) -> Scheduler:
    """Factory for the shipped scheduling policies."""
    if name not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}; "
                         f"available: {sorted(SCHEDULERS)}")
    if name == "fedlesscan":
        if history is None:
            raise ValueError("the fedlesscan scheduler needs a "
                             "ClientHistoryDB (history=...)")
        return FedLesScanScheduler(clients_per_round, history,
                                   max_rounds=max_rounds,
                                   ema_alpha=ema_alpha, rng=rng, seed=seed)
    if name == "rotation":
        return RotationScheduler(clients_per_round, client_ids or [],
                                 timeout_s=timeout_s, rng=rng, seed=seed)
    return SCHEDULERS[name](clients_per_round, rng=rng, seed=seed, **kwargs)
