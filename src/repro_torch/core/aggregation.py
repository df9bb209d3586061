"""Aggregation schemes — FedAvg and the paper's staleness-aware Eq. 3.

    w_{t+1} = Σ_k (t_k / t) · (n_k / n) · w^k_{t_k}

where t is the current round, t_k the round client k's update was produced
in, n_k the client dataset cardinality and n the total cardinality of the
aggregated clients.  Updates with t − t_k ≥ τ are discarded (τ = 2 in the
paper).  For t_k = t the scheme reduces exactly to FedAvg.

Updates are dicts of tensors.  `aggregate` has one path: every update is
one row of a (K, P) matrix (core/flatten.py, the ``ravel_pytree``
layout), the weighted sum runs as one ``fed_agg`` call (kernels/fed_agg.py:
the CUDA kernel on the card, its plain version on the CPU), or one
``fed_agg_sharded`` call over a mesh of more than one device, and the
result is unflattened back into the params tree.  Updates from the
vectorized executor are rows of its matrix (core/device_batch.py), and
the (K, P) input is gathered from it with one ``index_select``.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.fed_agg import fed_agg, fed_agg_sharded
from .flatten import flatten_into, flatten_params, tree_map

Pytree = Any


class ClientUpdate:
    """One client's local model update as stored in the parameter server.

    `payload_bytes` / `dense_bytes` are the simulated wire sizes of a
    compressed update; they stay None on the uncompressed path.

    An update from the vectorized executor is a row reference into its
    group's (K, P) matrix (``batch``/``batch_row``, core/device_batch.py):
    ``params`` builds the tree on first access, and ``flat_params`` reads
    the row without building it.  Assigning ``params`` detaches the
    update from its batch.
    """

    __slots__ = ("client_id", "num_samples", "round_number",
                 "training_time", "payload_bytes", "dense_bytes",
                 "dispatch_s", "batch", "batch_row", "_params")

    def __init__(self, client_id: str, params: Pytree = None,
                 num_samples: int = 0, round_number: int = 0,
                 training_time: float = 0.0,
                 payload_bytes: Optional[int] = None,
                 dense_bytes: Optional[int] = None,
                 dispatch_s: Optional[float] = None,
                 batch=None, batch_row: int = -1):
        if params is None and batch is None:
            raise ValueError(f"update {client_id!r} needs params or a "
                             f"device-batch row")
        self.client_id = client_id
        self._params = params
        self.num_samples = num_samples
        self.round_number = round_number   # t_k — round the update is for
        self.training_time = training_time
        self.payload_bytes = payload_bytes  # encoded wire size (simulated)
        self.dense_bytes = dense_bytes      # uncompressed fp32 wire size
        # wall-clock launch latency (telemetry; never enters virtual time)
        self.dispatch_s = dispatch_s
        self.batch = batch                  # DeviceUpdateBatch, or None
        self.batch_row = batch_row

    @property
    def params(self) -> Pytree:
        if self._params is None:
            self._params = self.batch.tree(self.batch_row)
        return self._params

    @params.setter
    def params(self, value: Pytree) -> None:
        self._params = value
        self.batch = None                  # the tree is now authoritative
        self.batch_row = -1

    def flat_params(self) -> torch.Tensor:
        """The flat (P,) view: the batch row when the tree was never
        built, else the tree flattened."""
        if self._params is None:
            return self.batch.row(self.batch_row)
        return flatten_params(self._params)[0]

    def __repr__(self) -> str:
        src = (f"batch_row={self.batch_row}" if self._params is None
               else "params=<tree>")
        return (f"ClientUpdate({self.client_id!r}, {src}, "
                f"n={self.num_samples}, round={self.round_number})")


def update_to_record(update: ClientUpdate) -> dict:
    """JSON-ready metadata of one update (checkpoint surface) — the
    params tree travels separately in the checkpoint's array store."""
    rec = {"client_id": update.client_id,
           "num_samples": update.num_samples,
           "round_number": update.round_number,
           "training_time": update.training_time}
    if update.payload_bytes is not None:
        rec["payload_bytes"] = update.payload_bytes
        rec["dense_bytes"] = update.dense_bytes
    if update.dispatch_s is not None:
        rec["dispatch_s"] = update.dispatch_s
    return rec


def update_from_record(rec: dict, params: Pytree) -> ClientUpdate:
    return ClientUpdate(params=params, client_id=rec["client_id"],
                        num_samples=rec["num_samples"],
                        round_number=rec["round_number"],
                        training_time=rec.get("training_time", 0.0),
                        payload_bytes=rec.get("payload_bytes"),
                        dense_bytes=rec.get("dense_bytes"),
                        dispatch_s=rec.get("dispatch_s"))


def fedavg_coefficients(updates: Sequence[ClientUpdate]) -> np.ndarray:
    n = float(sum(u.num_samples for u in updates)) or 1.0
    return np.array([u.num_samples / n for u in updates], dtype=np.float64)


def staleness_coefficients(updates: Sequence[ClientUpdate],
                           current_round: int) -> np.ndarray:
    """Eq. 3 coefficients (t_k/t)·(n_k/n). Round numbers are 0-based in the
    runtime, so the damping ratio uses (t_k+1)/(t+1)."""
    n = float(sum(u.num_samples for u in updates)) or 1.0
    t = float(current_round + 1)
    return np.array(
        [((u.round_number + 1) / t) * (u.num_samples / n) for u in updates],
        dtype=np.float64)


def flat_update_matrix(updates: Sequence[ClientUpdate]
                       ) -> Tuple[torch.Tensor, Any]:
    """(K, P) matrix of flattened updates, in the first update's flat
    dtype and on its device, plus the shared ``unflatten`` handle.  The
    matrix is fresh: nobody else holds it.

    When every update is a row of one executor batch, the rows come out
    of its matrix with one ``index_select``.  Otherwise each row is
    written in place: a batch row copied, a tree flattened into it."""
    first = updates[0]
    b = first.batch
    if b is not None and all(u.batch is b for u in updates):
        return b.gather([u.batch_row for u in updates]), b.unflatten
    if b is not None:
        flat0, unflatten = first.flat_params(), b.unflatten
    else:
        flat0, unflatten = flatten_params(first.params)
    mat = torch.empty((len(updates), flat0.numel()), dtype=flat0.dtype,
                      device=flat0.device)
    mat[0].copy_(flat0)
    for k, u in enumerate(updates[1:], start=1):
        if u.batch is not None:
            mat[k].copy_(u.flat_params())
        else:
            flatten_into(u.params, mat[k])
    return mat, unflatten


def coefficient_tensor(coeffs, device: torch.device) -> torch.Tensor:
    """Merge coefficients as the kernels take them: fp32 on ``device``."""
    return torch.as_tensor(np.asarray(coeffs, dtype=np.float32),
                           device=device)


def aggregate(updates: Sequence[ClientUpdate], coeffs: np.ndarray,
              mesh=None) -> Pytree:
    """Weighted sum Σ_k c_k · W_k over client updates: one ``fed_agg``
    call over their (K, P) matrix, or one ``fed_agg_sharded`` call with
    P split over ``mesh`` when it has more than one device."""
    mat, unflatten = flat_update_matrix(updates)
    cf = coefficient_tensor(coeffs, mat.device)
    if mesh is not None and mesh.size > 1:
        return unflatten(fed_agg_sharded(mat, cf, mesh).to(mat.device))
    return unflatten(fed_agg(mat, cf))


def fedavg_aggregate(updates: Sequence[ClientUpdate]) -> Pytree:
    """Plain FedAvg: Σ (n_k/n) w_k."""
    if not updates:
        raise ValueError("fedavg_aggregate needs at least one update")
    return aggregate(updates, fedavg_coefficients(updates))


def staleness_aggregate(updates: Sequence[ClientUpdate], current_round: int,
                        tau: int = 2) -> Optional[Pytree]:
    """Paper Eq. 3 with max-age cutoff τ: drop updates with t − t_k ≥ τ.

    Returns None when every update was discarded (caller keeps the old
    global model for this round).
    """
    fresh = [u for u in updates if (current_round - u.round_number) < tau]
    if not fresh:
        return None
    return aggregate(fresh, staleness_coefficients(fresh, current_round))


class RunningAggregator:
    """FedLess §III-A 'running average model aggregation': accumulate
    updates one by one in O(1) memory instead of stacking all K.

    Eq. 3 factorises as (Σ_k (t_k/t)·n_k·w_k) / (Σ_k n_k), so the server
    can fold each update into a numerator/denominator pair as it arrives
    — the production path when K × model-size doesn't fit the aggregator
    function's memory (paper: 7 GB aggregation function limit).
    """

    def __init__(self, current_round: int, tau: int = 2):
        self.current_round = current_round
        self.tau = tau
        self._num: Optional[Pytree] = None
        self._den: float = 0.0
        self.accepted = 0
        self.rejected = 0

    def add(self, update: ClientUpdate) -> bool:
        """Fold one update in; returns False if discarded by τ."""
        if (self.current_round - update.round_number) >= self.tau:
            self.rejected += 1
            return False
        damp = (update.round_number + 1) / (self.current_round + 1)
        scale = float(np.float32(damp * update.num_samples))
        if self._num is None:
            self._num = tree_map(lambda l: scale * l.float(), update.params)
        else:
            self._num = tree_map(lambda acc, l: acc + scale * l.float(),
                                 self._num, update.params)
        self._den += float(update.num_samples)
        self.accepted += 1
        return True

    def finalize(self) -> Optional[Pytree]:
        if self._num is None or self._den == 0.0:
            return None
        inv = float(np.float32(1.0 / self._den))
        return tree_map(lambda l: l * inv, self._num)


class UpdateStore:
    """Parameter-server-side store of pending client updates.

    Slow clients push updates after their round finished (semi-async);
    those stale updates are *included the next time aggregation runs*
    (paper §V-D) and dropped once older than τ.  Each update carries an
    arrival time (the client's virtual finish time): an update is only
    visible to aggregations that happen after it physically arrived —
    very slow clients therefore age across multiple rounds and τ
    genuinely discards them.
    """

    def __init__(self, tau: int = 2):
        self.tau = tau
        self._pending: List[tuple] = []   # (arrival_time, ClientUpdate)

    def push(self, update: ClientUpdate,
             arrival_time: float = 0.0) -> None:
        self._pending.append((arrival_time, update))

    def pop_for_round(self, current_round: int,
                      now: Optional[float] = None) -> List[ClientUpdate]:
        """Return fresh-enough *arrived* updates; keep future arrivals."""
        taken, kept = [], []
        for arrival, u in self._pending:
            if now is not None and arrival > now:
                kept.append((arrival, u))       # still in flight
            elif (current_round - u.round_number) < self.tau:
                taken.append(u)
            # else: aged out — dropped (paper §V-D)
        self._pending = kept
        return taken

    def __len__(self) -> int:
        return len(self._pending)

    # ---- checkpoint surface -------------------------------------------
    def state_dict(self, arrays: dict,
                   prefix: str = "strategy/pending") -> List[dict]:
        """Snapshot the pending entries; update trees go into `arrays`
        under `prefix`-keyed slots (the store owns its own layout — the
        strategies just forward the call)."""
        out = []
        for i, (arrival, update) in enumerate(self._pending):
            arrays[f"{prefix}/{i}"] = update.params
            rec = update_to_record(update)
            rec["arrival"] = arrival
            out.append(rec)
        return out

    def load_state_dict(self, entries: List[dict], arrays: dict,
                        prefix: str = "strategy/pending") -> None:
        self._pending = [
            (float(rec["arrival"]),
             update_from_record(rec, arrays[f"{prefix}/{i}"]))
            for i, rec in enumerate(entries)]
