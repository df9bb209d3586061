"""Client runtime — paper Algorithm 1, Client_Update.

Each FL client is (conceptually) a FaaS function: stateless between
invocations, loading the global model, training on its local shard, and
pushing the update + its measured training time back to the database.
`ClientPool.work_fn` is what the MockInvoker executes per invocation;
`ClientPool.batch_work_fn` trains a round's cohort at once through the
vectorized executor (fl/executor.py).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..core.aggregation import ClientUpdate
from ..data.synthetic import ArrayDataset
from .tasks import ClassificationTask

Pytree = Any


@dataclass
class ClientState:
    dataset: ArrayDataset
    test_dataset: Optional[ArrayDataset] = None


class ClientPool:
    """Holds every client's local shard + the shared task definition."""

    def __init__(self, task: ClassificationTask,
                 datasets: Dict[str, ArrayDataset],
                 test_datasets: Optional[Dict[str, ArrayDataset]] = None,
                 proximal_mu: float = 0.0, seed: int = 0,
                 compressor=None):
        self.task = task
        self.clients = {
            cid: ClientState(ds, (test_datasets or {}).get(cid))
            for cid, ds in datasets.items()
        }
        self.proximal_mu = proximal_mu
        self.seed = seed
        # optional core.compress.UpdateCompressor — when set, updates are
        # encoded (top-k / int8 + error feedback) on the way out of local
        # training and the ClientUpdate carries the simulated wire size
        self.compressor = compressor
        self._executor = None
        # membership is fixed after construction, so the sorted id list is
        # computed once — callers (and the interners memoizing on list
        # identity) see one stable object instead of a fresh O(N log N)
        # sort per access
        self._client_ids = sorted(self.clients)

    @property
    def client_ids(self):
        return self._client_ids

    def num_samples(self, cid: str) -> int:
        return len(self.clients[cid].dataset)

    def client_seed(self, cid: str, round_number: int) -> int:
        """Per-(client, round) training seed.  CRC32 rather than hash():
        Python salts string hashes per interpreter, which would make
        training trajectories differ between processes."""
        return zlib.crc32(
            f"{cid}:{round_number}:{self.seed}".encode()) % (2 ** 31)

    def package_update(self, cid: str, params: Pytree,
                       round_number: int, global_params: Pytree,
                       batch=None, row: int = -1) -> ClientUpdate:
        """Wrap trained params into the wire-format ClientUpdate: with a
        compressor the params become the server-side decode and the
        simulated payload/dense byte counts ride along; without one the
        update is the plain dense tree (byte-identical dense path).

        From the vectorized executor: pass ``batch``/``row`` (a
        ``DeviceUpdateBatch`` row) instead of ``params``.  A compressor
        then encodes the flat row and replaces it in place
        (``encode_flat``), and the update is a row reference whose
        ``.params`` is built on first access."""
        payload_bytes = dense_bytes = None
        if batch is not None:
            if self.compressor is not None:
                new_row, payload_bytes, dense_bytes = \
                    self.compressor.encode_flat(cid, batch.row(row),
                                                global_params)
                if payload_bytes is not None:
                    batch.set_row(row, new_row)
            return ClientUpdate(
                client_id=cid,
                num_samples=len(self.clients[cid].dataset),
                round_number=round_number,
                payload_bytes=payload_bytes, dense_bytes=dense_bytes,
                batch=batch, batch_row=row)
        if self.compressor is not None:
            params, payload_bytes, dense_bytes = self.compressor.encode(
                cid, params, global_params)
        return ClientUpdate(
            client_id=cid, params=params,
            num_samples=len(self.clients[cid].dataset),
            round_number=round_number,
            payload_bytes=payload_bytes, dense_bytes=dense_bytes)

    def work_fn(self, cid: str, global_params: Pytree,
                round_number: int) -> Tuple[ClientUpdate, float]:
        """Client_Update body: train locally, return the update and the
        nominal training duration for the virtual clock."""
        state = self.clients[cid]
        params, _loss = self.task.local_train(
            global_params, state.dataset, mu=self.proximal_mu,
            seed=self.client_seed(cid, round_number))
        update = self.package_update(cid, params, round_number,
                                     global_params)
        return update, self.task.nominal_work_seconds(state.dataset)

    # ------------------------------------------------------------------
    @property
    def executor(self):
        """The shared VectorizedExecutor, created on first use and kept on
        the task, so pools of one task (an experiment grid) share it."""
        if self._executor is None:
            from .executor import VectorizedExecutor
            self._executor = getattr(self.task, "_vec_executor", None)
            if self._executor is None:
                self._executor = VectorizedExecutor(self.task)
                self.task._vec_executor = self._executor
        return self._executor

    def batch_work_fn(self, cids, global_params: Pytree,
                      round_number: int) -> Dict[str, tuple]:
        """Vectorized Client_Update: `work_fn`'s contract for a whole
        round's cohort at once (fl/executor.py)."""
        return self.executor.run_clients(self, cids, global_params,
                                         round_number)
