"""Synthetic dataset generators.

The container is offline, so the paper's datasets (MNIST, FEMNIST,
Shakespeare, Google Speech) are replaced by synthetic generators that
preserve what the *scheduling* experiments actually depend on: input/label
shapes, class structure that a small model can learn (so accuracy curves
are meaningful), and per-client heterogeneity statistics.  The
partitioning protocols themselves (label-sorted shards etc.) are faithful
— see partition.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ArrayDataset:
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return self.x.shape[0]

    def subset(self, idx: np.ndarray) -> "ArrayDataset":
        return ArrayDataset(self.x[idx], self.y[idx])


def make_image_classification(n_samples: int, image_size: int = 28,
                              n_classes: int = 10, channels: int = 1,
                              noise: float = 0.35,
                              seed: int = 0) -> ArrayDataset:
    """MNIST-like: one smooth random template per class + pixel noise.

    Learnable by a small CNN within a few epochs; classes are balanced.
    """
    rng = np.random.default_rng(seed)
    # low-frequency class templates: random coarse grids upsampled
    coarse = rng.normal(size=(n_classes, 7, 7, channels))
    reps = image_size // 7
    templates = np.kron(coarse, np.ones((1, reps, reps, 1)))
    templates = templates[:, :image_size, :image_size, :]
    y = rng.integers(0, n_classes, size=n_samples)
    x = templates[y] + noise * rng.normal(
        size=(n_samples, image_size, image_size, channels))
    return ArrayDataset(x.astype(np.float32), y.astype(np.int32))


def make_char_lm(n_samples: int, seq_len: int = 80, vocab: int = 82,
                 order_classes: int = 8, seed: int = 0) -> ArrayDataset:
    """Shakespeare-like next-char prediction: sequences drawn from a
    low-entropy Markov chain (so an LSTM can reduce perplexity).

    x: (N, seq_len) int32 context, y: (N,) int32 next char.
    """
    rng = np.random.default_rng(seed)
    # sparse transition matrix: each char strongly prefers a few successors
    trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    seqs = np.empty((n_samples, seq_len + 1), dtype=np.int32)
    state = rng.integers(0, vocab, size=n_samples)
    for t in range(seq_len + 1):
        seqs[:, t] = state
        # vectorised categorical draw per current state
        u = rng.random(n_samples)
        cdf = np.cumsum(trans[state], axis=1)
        state = (u[:, None] < cdf).argmax(axis=1)
    del order_classes
    return ArrayDataset(seqs[:, :seq_len], seqs[:, seq_len])


def make_speech_commands(n_samples: int, frames: int = 32, mels: int = 32,
                         n_classes: int = 35, noise: float = 0.4,
                         seed: int = 0) -> ArrayDataset:
    """Google-Speech-like keyword spotting: class-dependent spectro-temporal
    patterns (a 'keyword' = a characteristic ridge in the mel spectrogram).
    """
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, frames)[None, :, None]
    f = np.linspace(0, 1, mels)[None, None, :]
    freq = rng.uniform(0.1, 0.9, size=(n_classes, 1, 1))
    slope = rng.uniform(-0.5, 0.5, size=(n_classes, 1, 1))
    width = rng.uniform(0.05, 0.2, size=(n_classes, 1, 1))
    ridge = np.exp(-((f - (freq + slope * t)) ** 2) / (2 * width ** 2))
    y = rng.integers(0, n_classes, size=n_samples)
    x = ridge[y] + noise * rng.normal(size=(n_samples, frames, mels))
    return ArrayDataset(x[..., None].astype(np.float32), y.astype(np.int32))


def make_token_lm(n_tokens: int, vocab: int = 32000, seq_len: int = 256,
                  seed: int = 0) -> ArrayDataset:
    """Token stream for pretraining drivers: Zipf-distributed ids with local
    bigram structure. x: (N, seq_len), y = x shifted by one."""
    rng = np.random.default_rng(seed)
    n_seq = max(1, n_tokens // (seq_len + 1))
    base = rng.zipf(1.3, size=(n_seq, seq_len + 1)).astype(np.int64)
    toks = np.minimum(base, vocab - 1).astype(np.int32)
    # inject bigram structure: every even position repeats prev+1 mod vocab
    toks[:, 2::2] = (toks[:, 1:-1:2] + 1) % vocab
    return ArrayDataset(toks[:, :-1], toks[:, 1:])
