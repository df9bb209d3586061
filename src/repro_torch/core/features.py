"""Clustering features — paper §V-C.

trainingEma      : EMA over the client's recorded training times; a weighted
                   average that gives higher weight to recent rounds.
missedRoundEma   : EMA over (missed_round / current_round) ratios — recent
                   misses penalise more, and a given miss decays as training
                   progresses (the denominator grows).
totalEma (Eq. 2) : trainingEma + missedRoundEma * maxTrainingTime.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .history import ClientRecord


def ema_step(previous: "float | None", value: float,
             alpha: float = 0.5) -> float:
    """One EMA update: `alpha` on the new observation, seeded by the
    first value (matching `ema` over the full sequence)."""
    if previous is None:
        return float(value)
    return alpha * float(value) + (1.0 - alpha) * float(previous)


def normalize01(values: np.ndarray, mask: "np.ndarray | None" = None,
                dtype=np.float64) -> np.ndarray:
    """Min-max normalise to [0, 1] over the entries selected by `mask`
    (all by default); constant input maps to 0.0, unselected entries to
    the midpoint 0.5 (a neutral prior for clients without data).
    `dtype` lets fleet-scale callers run the passes in float32; the
    float64 default is bit-stable with the historical implementation."""
    values = np.asarray(values, dtype=dtype)
    if mask is None:                    # no gather copies on the hot path
        if values.size == 0:
            return np.full(values.shape, 0.5, dtype=dtype)
        lo, hi = float(values.min()), float(values.max())
        if hi <= lo:
            return np.zeros(values.shape, dtype=dtype)
        return (values - lo) / (hi - lo)
    out = np.full(values.shape, 0.5, dtype=dtype)
    sel = np.asarray(mask)
    if not np.any(sel):
        return out
    vsel = values[sel]
    lo, hi = float(vsel.min()), float(vsel.max())
    out[sel] = 0.0 if hi <= lo else (vsel - lo) / (hi - lo)
    return out


def ema(values: Sequence[float], alpha: float = 0.5) -> float:
    """Exponential moving average, most-recent-last.

    alpha is the smoothing factor applied to the newest observation; the
    paper uses an (unspecified-parameter) EMA, we default to 0.5 which
    half-lives one round.
    """
    if len(values) == 0:
        return 0.0
    acc = float(values[0])
    for v in values[1:]:
        acc = alpha * float(v) + (1.0 - alpha) * acc
    return acc


def training_ema(rec: ClientRecord, alpha: float = 0.5) -> float:
    return ema(rec.training_times, alpha)


def missed_round_ema(rec: ClientRecord, current_round: int,
                     alpha: float = 0.5) -> float:
    """EMA over missed-round ratios (paper §V-C).

    Each missed round number is divided by the current round number, so the
    penalty of a specific miss decreases as training progresses.
    """
    if current_round <= 0 or not rec.missed_rounds:
        return 0.0
    ratios = [min(1.0, (m + 1) / (current_round + 1))
              for m in sorted(rec.missed_rounds)]
    return ema(ratios, alpha)


def total_ema(rec: ClientRecord, current_round: int,
              max_training_time: float, alpha: float = 0.5) -> float:
    """Eq. 2: totalEma = trainingEma + missedRoundEma * maxTrainingTime."""
    return (training_ema(rec, alpha)
            + missed_round_ema(rec, current_round, alpha) * max_training_time)


def feature_matrix(records: Sequence[ClientRecord], current_round: int,
                   alpha: float = 0.5) -> np.ndarray:
    """(N, 2) clustering features: [trainingEma, missedRoundEma·maxT].

    maxTrainingTime is taken over the participating records (so the missed-
    round penalty is commensurate with the training-time scale), matching
    Eq. 2's scaling.
    """
    if not records:
        return np.zeros((0, 2), dtype=np.float64)
    t_emas = np.array([training_ema(r, alpha) for r in records])
    max_t = float(np.max([max(r.training_times) if r.training_times else 0.0
                          for r in records])) or 1.0
    m_emas = np.array(
        [missed_round_ema(r, current_round, alpha) for r in records])
    return np.stack([t_emas, m_emas * max_t], axis=1)


# ---------------------------------------------------------------------------
# Vectorized path over the array-backed history store.
#
# The recurrences below run the *same* IEEE-754 operation sequence as the
# scalar reference above, just batched across clients (pad + mask instead of
# ragged loops), so the results are bit-identical — the store-parity gate in
# tests/test_fleet_scale.py depends on this.
# ---------------------------------------------------------------------------

def pad_ragged(lists: Sequence[Sequence[float]], fill: float = 0.0):
    """(values, lengths): ragged lists padded into an (N, Lmax) float64
    matrix.  Cost is O(total observations), not O(fleet)."""
    lengths = np.fromiter((len(v) for v in lists), np.int64, len(lists))
    width = int(lengths.max()) if lengths.size else 0
    values = np.full((len(lists), width), fill, np.float64)
    for i, vs in enumerate(lists):
        if vs:
            values[i, :len(vs)] = vs
    return values, lengths


def batched_ema(values: np.ndarray, lengths: np.ndarray,
                alpha: float = 0.5) -> np.ndarray:
    """Row-wise `ema` over padded rows; empty rows → 0.0.

    Iterates over *columns* (sequence length ≈ #rounds), vectorized over
    rows (#clients) — and each step applies exactly
    ``alpha * v + (1 - alpha) * acc`` like the scalar loop.
    """
    n, width = values.shape
    if width == 0:
        return np.zeros(n, np.float64)
    acc = np.where(lengths > 0, values[:, 0], 0.0)
    one_minus = 1.0 - alpha
    for j in range(1, width):
        step = alpha * values[:, j] + one_minus * acc
        acc = np.where(j < lengths, step, acc)
    return acc


def batched_missed_round_ema(missed: Sequence[Sequence[int]],
                             current_round: int,
                             alpha: float = 0.5) -> np.ndarray:
    """Vectorized `missed_round_ema` over ragged missed-round lists."""
    n = len(missed)
    if current_round <= 0 or n == 0:
        return np.zeros(n, np.float64)
    values, lengths = pad_ragged(missed, fill=np.inf)
    if values.shape[1] == 0:
        return np.zeros(n, np.float64)
    values.sort(axis=1)                  # per-row sorted; inf pads sink right
    np.putmask(values, ~np.isfinite(values), 0.0)
    ratios = np.minimum(1.0, (values + 1.0) / float(current_round + 1))
    return batched_ema(ratios, lengths, alpha)


def _store_t_emas(db, idx: np.ndarray, alpha: float,
                  dtype=np.float64) -> np.ndarray:
    """Training-time EMAs for store rows — the maintained `_t_ema`
    column when `alpha` matches the store's smoothing factor (an O(|idx|)
    gather), else the ragged recompute.  Both paths are bit-identical.
    `dtype=float32` gathers the store's downcast shadow column."""
    pre = (db.t_ema_of(idx, alpha, dtype)
           if hasattr(db, "t_ema_of") else None)
    if pre is not None:
        return pre
    t_vals, t_lens = pad_ragged(db.ragged_times(idx))
    return batched_ema(t_vals, t_lens, alpha)


def _store_missed_emas(db, idx: np.ndarray, current_round: int,
                       alpha: float) -> np.ndarray:
    """Missed-round EMAs for store rows — must be recomputed per propose
    (the ratios depend on `current_round`), but off the store's dense
    inf-padded matrix instead of N ragged Python lists when possible.
    Returns None to mean "identically zero" (no selected row has any
    missed round) so callers can skip the zero-array passes."""
    if current_round <= 0 or idx.size == 0:
        return None
    dense = db.missed_matrix(idx) if hasattr(db, "missed_matrix") else None
    if dense is None:
        return batched_missed_round_ema(db.ragged_missed(idx),
                                        current_round, alpha)
    values, lengths = dense
    if values.shape[1] == 0:
        return None
    values.sort(axis=1)                  # fancy-index copy: safe in place
    np.putmask(values, ~np.isfinite(values), 0.0)
    ratios = np.minimum(1.0, (values + 1.0) / float(current_round + 1))
    return batched_ema(ratios, lengths, alpha)


def feature_matrix_from_store(db, idx: np.ndarray, current_round: int,
                              alpha: float = 0.5,
                              dtype=np.float64,
                              max_t: "float | None" = None) -> np.ndarray:
    """`feature_matrix` computed straight off a `ClientHistoryDB`'s arrays
    for the rows in `idx` — bit-identical to the record-based path at the
    float64 default.  Fleet-scale callers pass float32: the matrix only
    feeds the sketch clusterer there, and halving its footprint halves
    the bandwidth of every downstream pass.  `max_t` lets a caller that
    already knows max(t_max[idx]) — or can compute it more cheaply, via
    a thunk — supply it; it must equal that max exactly.  It is only
    evaluated when some selected row has missed a round (the zero
    missed-EMA column never scales)."""
    if idx.size == 0:
        return np.zeros((0, 2), dtype=dtype)
    t_emas = _store_t_emas(db, idx, alpha, dtype)
    m_emas = _store_missed_emas(db, idx, current_round, alpha)
    if m_emas is not None:
        if callable(max_t):
            max_t = max_t()
        elif max_t is None:
            max_t = float(db.t_max_of(idx).max()) or 1.0
    if dtype == np.float64:
        col1 = (np.zeros(idx.size, np.float64) if m_emas is None
                else m_emas * max_t)    # 0·max_t == 0: same bits
        return np.stack([t_emas, col1], axis=1)
    out = np.empty((idx.size, 2), dtype=dtype)
    out[:, 0] = t_emas
    if m_emas is None:
        out[:, 1] = 0.0
    else:
        out[:, 1] = m_emas * max_t
    return out


def total_ema_from_store(db, idx: np.ndarray, current_round: int,
                         max_training_time: float,
                         alpha: float = 0.5) -> np.ndarray:
    """Vectorized Eq. 2 over store rows `idx`."""
    if idx.size == 0:
        return np.zeros(0, np.float64)
    t_emas = _store_t_emas(db, idx, alpha)
    m_emas = _store_missed_emas(db, idx, current_round, alpha)
    if m_emas is None:
        return t_emas                   # t + 0·max ≡ t: same bits
    return t_emas + m_emas * max_training_time
