"""Client runtime — paper Algorithm 1, Client_Update.

Each FL client is (conceptually) a FaaS function: stateless between
invocations, loading the global model, training on its local shard, and
pushing the update + its measured training time back to the database.
`ClientPool.work_fn` is what the MockInvoker executes per invocation.
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
                 proximal_mu: float = 0.0, seed: int = 0):
        self.task = task
        self.clients = {
            cid: ClientState(ds, (test_datasets or {}).get(cid))
            for cid, ds in datasets.items()
        }
        self.proximal_mu = proximal_mu
        self.seed = seed
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

    def work_fn(self, cid: str, global_params: Pytree,
                round_number: int) -> Tuple[ClientUpdate, float]:
        """Client_Update body: train locally, return the update and the
        nominal training duration for the virtual clock."""
        state = self.clients[cid]
        params, _loss = self.task.local_train(
            global_params, state.dataset, mu=self.proximal_mu,
            seed=self.client_seed(cid, round_number))
        update = ClientUpdate(client_id=cid, params=params,
                              num_samples=len(state.dataset),
                              round_number=round_number)
        return update, self.task.nominal_work_seconds(state.dataset)
