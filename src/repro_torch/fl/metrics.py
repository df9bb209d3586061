"""Strategy-quality metrics — paper §VI-A5.

EUR (effective update ratio): successful / selected clients in a round.
In barrier-free (async) mode there is no round cohort, so the per-round
ratio is degenerate; `windowed_update_ratio` is the async-comparable
form — updates merged / invocations issued over a window of virtual
time (the span between consecutive aggregation events).
Bias: difference between the invocation counts of the most- and
least-invoked clients over the whole session.
Weighted accuracy: per-client test accuracy weighted by test-set
cardinality (the paper's federated evaluation).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def effective_update_ratio(n_success: int, n_selected: int) -> float:
    return n_success / n_selected if n_selected else 1.0


def windowed_update_ratio(n_merged: int, n_resolved: int) -> float:
    """Async-mode EUR: updates merged into the global model per
    invocation *resolved* during a wall-clock (virtual-time) window —
    every resolved invocation was issued, so summed over a run this
    telescopes to merged/issued without crediting or debiting the
    invocations still in flight at the window edge.  Windows with no
    resolutions report 1.0 (nothing was wasted)."""
    return effective_update_ratio(n_merged, n_resolved)


def trailing_eur(stats: Sequence, window: int = 3) -> float:
    """Mean EUR over the trailing `window` RoundStats — the adaptive
    scheduler's grow/shrink signal."""
    recent = list(stats)[-window:]
    if not recent:
        return 1.0
    return float(np.mean([r.eur for r in recent]))


def trailing_straggler_ratio(stats: Sequence, window: int = 3) -> float:
    """Fraction of selected clients that were late or crashed over the
    trailing `window` RoundStats."""
    recent = list(stats)[-window:]
    selected = sum(len(r.selected) for r in recent)
    if not selected:
        return 0.0
    wasted = sum(len(r.late) + len(r.crashed) for r in recent)
    return wasted / selected


class TrailingMetricsCache:
    """Identity-keyed memo for the adaptive scheduler's trailing window.

    `trailing_eur` / `trailing_straggler_ratio` only depend on the last
    `window` RoundStats objects, so the pair is computed once per
    distinct window and replayed for free on repeated `cohort_size`
    calls against unchanged telemetry (async refills, re-entrant
    sizing).  Delegates to the module functions — values are identical.
    """

    __slots__ = ("window", "_key", "_value")

    def __init__(self, window: int = 3):
        self.window = window
        self._key: tuple = ()
        self._value = (1.0, 0.0)

    def compute(self, stats: Sequence) -> tuple:
        """(trailing_eur, trailing_straggler_ratio) over `stats`."""
        recent = list(stats)[-self.window:]
        key = tuple(map(id, recent))
        if key != self._key or not key:
            self._value = (trailing_eur(recent, self.window),
                           trailing_straggler_ratio(recent, self.window))
            self._key = key
        return self._value


def time_to_accuracy(accuracy_curve: Sequence[tuple],
                     round_durations: Sequence[float],
                     target: float) -> float:
    """Virtual seconds until the evaluated accuracy first reaches
    `target` (inf if it never does).  `accuracy_curve` is the
    ExperimentResult's [(round, accuracy), ...] and `round_durations`
    the per-round duration list."""
    for rnd, acc in accuracy_curve:
        if acc >= target:
            return float(sum(round_durations[:rnd + 1]))
    return float("inf")


def bias(invocations: Dict[str, int]) -> int:
    if not invocations:
        return 0
    counts = list(invocations.values())
    return int(max(counts) - min(counts))


def invocation_distribution(invocations: Dict[str, int]) -> np.ndarray:
    return np.array(sorted(invocations.values()), dtype=np.int64)


def weighted_accuracy(per_client: Sequence[tuple]) -> float:
    """per_client: iterable of (accuracy, test_cardinality)."""
    accs = np.array([a for a, _ in per_client], dtype=np.float64)
    card = np.array([c for _, c in per_client], dtype=np.float64)
    if card.sum() == 0:
        return float(accs.mean()) if len(accs) else 0.0
    return float(np.sum(accs * card) / card.sum())
