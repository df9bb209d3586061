"""Federated partitioning protocols (paper §VI-A1).

- `label_sorted_shards`: the paper's MNIST protocol — sort by label, split
  into shards of fixed size, deal shards to clients (non-IID: most clients
  see only 1-2 classes).
- `dirichlet_partition`: standard non-IID label-skew control (alpha).
- `lognormal_sizes`: statistical heterogeneity in per-client cardinality
  (FEMNIST has ~226 imgs/client, Shakespeare ~3743 — heavy-tailed).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .synthetic import ArrayDataset


def label_sorted_shards(ds: ArrayDataset, n_clients: int,
                        shards_per_client: int = 2,
                        seed: int = 0) -> Dict[str, ArrayDataset]:
    """Sort by label → split into n_clients*shards_per_client shards →
    deal `shards_per_client` random shards to each client."""
    rng = np.random.default_rng(seed)
    order = np.argsort(ds.y, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    out = {}
    for c in range(n_clients):
        take = perm[c * shards_per_client:(c + 1) * shards_per_client]
        idx = np.concatenate([shards[s] for s in take])
        out[f"client_{c}"] = ds.subset(idx)
    return out


def dirichlet_partition(ds: ArrayDataset, n_clients: int, alpha: float = 0.5,
                        seed: int = 0) -> Dict[str, ArrayDataset]:
    rng = np.random.default_rng(seed)
    classes = np.unique(ds.y)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for k in classes:
        idx = np.nonzero(ds.y == k)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for c, chunk in enumerate(np.split(idx, cuts)):
            client_idx[c].extend(chunk.tolist())
    return {f"client_{c}": ds.subset(np.array(sorted(ix), dtype=np.int64))
            for c, ix in enumerate(client_idx)}


def lognormal_sizes(n_clients: int, mean_samples: int, sigma: float = 0.6,
                    min_samples: int = 8, seed: int = 0) -> np.ndarray:
    """Heavy-tailed per-client sample counts summing roughly to
    n_clients*mean_samples."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=n_clients)
    sizes = np.maximum(min_samples,
                       (raw / raw.sum() * n_clients * mean_samples)).astype(int)
    return sizes


def partition_by_sizes(ds: ArrayDataset, sizes: np.ndarray,
                       seed: int = 0) -> Dict[str, ArrayDataset]:
    """IID split with heterogeneous cardinalities."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ds))
    out, pos = {}, 0
    for c, s in enumerate(sizes):
        s = int(min(s, len(ds) - pos)) if pos < len(ds) else 0
        idx = order[pos:pos + s] if s > 0 else order[:1]
        out[f"client_{c}"] = ds.subset(idx)
        pos += s
    return out
