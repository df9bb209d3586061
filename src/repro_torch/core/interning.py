"""Stable client-id ↔ index interning — the substrate of fleet scale.

Every per-client structure in the hot path (behavioural history,
scheduler score tallies, routing assignments) is a flat NumPy array
indexed by a *stable* integer id.  `ClientInterner` owns the mapping:
a client id is interned once, keeps its index forever (indices are
never reused or compacted), and the arrays hanging off the interner
grow geometrically alongside it.

`indices_for` is the per-call bridge from the driver's id sequences to
array indices.  Converting a million-entry pool to indices costs a
million dict lookups, so the result is memoized per pool *object*: the
training driver passes the same (immutable) population list every
propose, and the memo turns the conversion into an O(1) identity check.
Sequences must therefore not be mutated in place after being passed —
pass a fresh list when the pool composition changes (the drivers do).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class ClientInterner:
    """Bidirectional client-id ↔ dense-index table with stable indices."""

    __slots__ = ("_index", "_ids", "_pool_cache", "_lex_cache")

    def __init__(self, ids: Optional[Iterable[str]] = None):
        self._index: Dict[str, int] = {}
        self._ids: List[str] = []
        # id(seq) -> (len(seq), size_at_cache, np.ndarray of indices)
        self._pool_cache: Dict[int, Tuple[int, int, np.ndarray]] = {}
        self._lex_cache: Optional[Tuple[int, np.ndarray]] = None
        if ids is not None:
            self.intern_many(ids)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, client_id: str) -> bool:
        return client_id in self._index

    @property
    def ids(self) -> List[str]:
        """All interned ids, index order (do not mutate)."""
        return self._ids

    def id_of(self, index: int) -> str:
        return self._ids[index]

    def index_of(self, client_id: str) -> int:
        """Index of an already-interned id (KeyError if unknown)."""
        return self._index[client_id]

    def lookup(self, client_id: str) -> int:
        """Index of `client_id`, or -1 when never interned."""
        return self._index.get(client_id, -1)

    # ------------------------------------------------------------------
    def intern(self, client_id: str) -> int:
        idx = self._index.get(client_id)
        if idx is None:
            idx = len(self._ids)
            self._index[client_id] = idx
            self._ids.append(client_id)
        return idx

    def intern_many(self, client_ids: Iterable[str]) -> np.ndarray:
        get = self._index.get
        out = np.empty(len(client_ids)
                       if hasattr(client_ids, "__len__") else 0, np.int64)
        if out.size:
            for i, cid in enumerate(client_ids):
                idx = get(cid)
                out[i] = self.intern(cid) if idx is None else idx
            return out
        return np.array([self.intern(c) for c in client_ids], np.int64)

    # ------------------------------------------------------------------
    def indices_for(self, client_ids: Sequence[str],
                    intern_missing: bool = True) -> np.ndarray:
        """Index array for a pool sequence, memoized on object identity.

        The memo entry is invalidated when the sequence's length changes
        (cheap guard against in-place mutation) and is only reused when
        no id in it could have been re-interned (indices are stable, so
        growth never invalidates existing entries).
        """
        key = id(client_ids)
        hit = self._pool_cache.get(key)
        if hit is not None and hit[0] == len(client_ids):
            return hit[2]
        if intern_missing:
            idx = self.intern_many(client_ids)
        else:
            get = self._index.get
            idx = np.array([get(c, -1) for c in client_ids], np.int64)
        if len(self._pool_cache) > 8:       # tiny LRU: drop everything
            self._pool_cache.clear()
        self._pool_cache[key] = (len(client_ids), len(self._ids), idx)
        return idx

    def lex_ranks(self) -> np.ndarray:
        """`ranks[i]` = rank of `ids[i]` in lexicographic id order.

        Because ids are unique, sorting by `(key, ranks[i])` is exactly
        sorting by `(key, client_id)` — but with pure integer keys, so
        the scheduler's cohort ordering stays `argpartition`-able at
        fleet scale.  Cached; rebuilt lazily after interner growth.
        """
        n = len(self._ids)
        if self._lex_cache is not None and self._lex_cache[0] == n:
            return self._lex_cache[1]
        order = np.argsort(np.array(self._ids))     # '<U*' array: C compares
        ranks = np.empty(n, np.int64)
        ranks[order] = np.arange(n, dtype=np.int64)
        self._lex_cache = (n, ranks)
        return ranks

    # ---- checkpoint surface ------------------------------------------
    def state_dict(self) -> dict:
        return {"ids": list(self._ids)}

    def load_state_dict(self, state: dict) -> None:
        self._ids = list(state.get("ids", []))
        self._index = {cid: i for i, cid in enumerate(self._ids)}
        self._pool_cache.clear()
        self._lex_cache = None


def grow_to(array: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Return `array` with capacity ≥ n (geometric growth, `fill` for
    the new tail).  No-op when already large enough."""
    if array.shape[0] >= n:
        return array
    cap = max(n, 2 * array.shape[0], 16)
    out = np.full((cap, *array.shape[1:]), fill, dtype=array.dtype)
    out[:array.shape[0]] = array
    return out
