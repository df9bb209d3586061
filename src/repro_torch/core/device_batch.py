"""The vectorized executor's trained updates as one (K, P) matrix.

The executor (fl/executor.py) trains a group of clients as K-stacked
params and flattens them, once, into a (K_bucket, P) matrix in the
``core/flatten.py`` order (``ravel_pytree``'s).  ``DeviceUpdateBatch``
hands that matrix downstream: ``ClientPool.package_update`` makes each
``ClientUpdate`` a row reference, ``UpdateCompressor.encode_flat`` reads
and replaces rows, and the merge (``core/aggregation.flat_update_matrix``)
gathers its (K, P) input straight out of the matrix.  A client's params
tree is built only when a consumer needs tree structure (``tree``), and
the loss vector crosses to the host in one transfer.

The port always takes this path; it has no switch back to per-client
trees, so ``pipeline_enabled()`` is always True.

``transfer_stats`` counts, process-wide as the reference does, the bytes
and rows rebuilt as per-client trees (``tree``) and the host transfers of
the loss vector (``loss``); ``reset_transfer_stats`` zeroes them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

Pytree = Any


def pipeline_enabled() -> bool:
    """Whether consumers read the batch matrix: always, in the port (the
    reference's ``REPRO_DEVICE_PIPELINE`` switch has no counterpart)."""
    return True


# the reference's host-transfer counters (core/device_batch.py there)
_TRANSFER = {"materialize_bytes": 0, "materialize_rows": 0,
             "loss_syncs": 0}


def transfer_stats() -> Dict[str, int]:
    return dict(_TRANSFER)


def reset_transfer_stats() -> None:
    for k in _TRANSFER:
        _TRANSFER[k] = 0


def count_materialization(nbytes: int, rows: int = 1) -> None:
    _TRANSFER["materialize_bytes"] += int(nbytes)
    _TRANSFER["materialize_rows"] += int(rows)


def count_loss_sync() -> None:
    _TRANSFER["loss_syncs"] += 1


class DeviceUpdateBatch:
    """One executor group's trained updates as a device-resident matrix.

    * ``mat`` — (K_bucket, P) flat update matrix; rows at and beyond
      ``len(cids)`` are bucket padding and are never addressed;
    * ``cids`` — the real clients; row i belongs to ``cids[i]``;
    * ``unflatten`` — flat (P,) row → params tree (one for the group);
    * ``losses`` — (K_bucket,) mean training loss per client, fetched to
      the host in one transfer on the first ``loss`` call.

    ``set_row`` replaces a row (the compression stage's server-side
    decode) without touching ``mat``; ``gather`` assembles a merge matrix
    from any rows as a fresh tensor.
    """

    def __init__(self, mat: torch.Tensor, cids: Sequence[str],
                 unflatten: Callable[[torch.Tensor], Pytree],
                 losses: Optional[torch.Tensor] = None):
        if mat.dim() != 2 or mat.shape[0] < len(cids):
            raise ValueError(f"update matrix {tuple(mat.shape)} cannot hold "
                             f"{len(cids)} client rows")
        self.mat = mat
        self.cids = tuple(cids)
        self.unflatten = unflatten
        self._losses = losses
        self._losses_np: Optional[np.ndarray] = None
        self._row_override: Dict[int, torch.Tensor] = {}
        self._trees: Dict[int, Pytree] = {}

    @property
    def num_clients(self) -> int:
        return len(self.cids)

    @property
    def num_params(self) -> int:
        return int(self.mat.shape[1])

    def row(self, i: int) -> torch.Tensor:
        """Client i's flat (P,) update (on the device)."""
        if not 0 <= i < len(self.cids):
            raise IndexError(f"row {i} out of range for "
                             f"{len(self.cids)} clients")
        override = self._row_override.get(i)
        return override if override is not None else self.mat[i]

    def set_row(self, i: int, flat: torch.Tensor) -> None:
        """Replace client i's update; a tree built from the old row is
        dropped."""
        if tuple(flat.shape) != (self.num_params,):
            raise ValueError(f"row shape {tuple(flat.shape)} != "
                             f"({self.num_params},)")
        self.row(i)                      # range check
        self._row_override[i] = flat
        self._trees.pop(i, None)

    def gather(self, rows: Sequence[int]) -> torch.Tensor:
        """(len(rows), P) merge matrix, a fresh tensor (never a view of
        ``mat``)."""
        rows = list(rows)
        for r in rows:
            self.row(r)                  # range check
        if any(r in self._row_override for r in rows):
            return torch.stack([self.row(r) for r in rows])
        index = torch.tensor(rows, dtype=torch.int64, device=self.mat.device)
        return self.mat.index_select(0, index)

    def tree(self, i: int) -> Pytree:
        """Client i's params tree, built on first use and kept."""
        tree = self._trees.get(i)
        if tree is None:
            flat = self.row(i)
            tree = self.unflatten(flat)
            self._trees[i] = tree
            count_materialization(flat.numel() * flat.element_size())
        return tree

    def loss(self, i: int) -> float:
        """Client i's mean training loss; the whole loss vector crosses to
        the host once, on the first call."""
        if self._losses is None:
            return 0.0
        if self._losses_np is None:
            self._losses_np = self._losses.detach().cpu().numpy()
            count_loss_sync()
        return float(self._losses_np[i])
