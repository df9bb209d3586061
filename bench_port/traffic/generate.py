"""The one generator of the benchmark's inputs, driven by a traffic file.

Frozen copies of the synthetic data makers and the partitioners that the
program's examples use (``data/synthetic.py``, ``data/partition.py``), so
that a later change to the program cannot change what the benchmark
feeds it.  Everything is drawn from the run's seed with numpy, in bulk,
on the host; the same seed gives the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass
class Shard:
    """One client's samples: ``x`` (n, ...) and labels ``y`` (n,)."""
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return self.x.shape[0]


def image_classification(n: int, size: int, classes: int, channels: int,
                         noise: float, rng: np.random.Generator) -> Shard:
    """One smooth random template a class (a 7x7 grid upsampled) plus
    pixel noise; NHWC float32 images, int32 labels."""
    coarse = rng.normal(size=(classes, 7, 7, channels))
    reps = size // 7
    templates = np.kron(coarse, np.ones((1, reps, reps, 1)))[:, :size, :size]
    y = rng.integers(0, classes, size=n)
    x = templates[y] + noise * rng.normal(size=(n, size, size, channels))
    return Shard(x.astype(np.float32), y.astype(np.int32))


def token_stream(n_seq: int, seq_len: int, vocab: int,
                 rng: np.random.Generator) -> Shard:
    """Zipf(1.3) token ids below ``vocab`` with a bigram rule (every even
    position repeats the previous id plus one): ``x`` (n_seq, seq_len)
    int32, ``y`` the same shifted by one position."""
    base = rng.zipf(1.3, size=(n_seq, seq_len + 1)).astype(np.int64)
    toks = np.minimum(base, vocab - 1).astype(np.int32)
    toks[:, 2::2] = (toks[:, 1:-1:2] + 1) % vocab
    return Shard(toks[:, :-1], toks[:, 1:])


def label_sorted_shards(ds: Shard, n_clients: int, shards_per_client: int,
                        rng: np.random.Generator) -> Dict[str, Shard]:
    """Sort by label, split into n_clients·shards_per_client shards, deal
    ``shards_per_client`` random shards to each client."""
    order = np.argsort(ds.y, kind="stable")
    n_shards = n_clients * shards_per_client
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    out = {}
    for c in range(n_clients):
        take = perm[c * shards_per_client:(c + 1) * shards_per_client]
        idx = np.concatenate([shards[s] for s in take])
        out[f"client_{c}"] = Shard(ds.x[idx], ds.y[idx])
    return out


def random_shards(ds: Shard, n_clients: int,
                  rng: np.random.Generator) -> Dict[str, Shard]:
    """A random permutation split into ``n_clients`` equal shards."""
    order = rng.permutation(len(ds))
    return {f"client_{i}": Shard(ds.x[s], ds.y[s])
            for i, s in enumerate(np.array_split(order, n_clients))}


def client_shards(model: dict, traffic: dict, seed: int) -> Dict[str, Shard]:
    """The clients' training shards of an FL mix: ``traffic["data"]``
    names the maker and its sizes, ``traffic["partition"]`` the split."""
    rng = np.random.default_rng(seed)
    data, n_clients = traffic["data"], traffic["clients"]
    if data["maker"] == "image_classification":
        full = image_classification(
            n_clients * data["samples_per_client"], model["image_size"],
            model["classes"], model["channels"], data["noise"], rng)
    elif data["maker"] == "token_stream":
        full = token_stream(n_clients * data["samples_per_client"],
                            data["seq_len"], model["vocab_size"], rng)
        full = Shard(full.x, full.y[:, -1])     # the last position's label
    else:
        raise ValueError(f"unknown data maker {data['maker']!r}")
    if traffic["partition"] == "label_sorted_shards":
        return label_sorted_shards(full, n_clients,
                                   traffic["shards_per_client"], rng)
    if traffic["partition"] == "random_shards":
        return random_shards(full, n_clients, rng)
    raise ValueError(f"unknown partition {traffic['partition']!r}")


def token_batches(model: dict, traffic: dict, seed: int) -> Shard:
    """The train mix's pool of sequences; step i reads rows
    ``(i·batch + r) mod pool`` (every step of a run is a new set of
    rows while i·batch < pool)."""
    rng = np.random.default_rng(seed)
    return token_stream(traffic["pool_sequences"], traffic["seq_len"],
                        model["vocab_size"], rng)
