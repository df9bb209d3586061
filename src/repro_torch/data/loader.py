"""Minimal batching pipeline for client-local training loops."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from .synthetic import ArrayDataset


def batches(ds: ArrayDataset, batch_size: int, rng: np.random.Generator,
            drop_remainder: bool = False) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One shuffled epoch of (x, y) minibatches."""
    order = rng.permutation(len(ds))
    n = len(order)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for i in range(0, stop, batch_size):
        idx = order[i:i + batch_size]
        yield ds.x[idx], ds.y[idx]


def num_batches(ds: ArrayDataset, batch_size: int,
                drop_remainder: bool = False) -> int:
    n = len(ds)
    return n // batch_size if drop_remainder else -(-n // batch_size)
