"""DBSCAN + Calinski–Harabasz, from scratch (no sklearn in this env).

The paper (§V-C) clusters participant clients with DBSCAN on the 2-D
feature matrix, grid-searches ε to maximise the Calinski–Harabasz index,
and treats outliers as one extra cluster.  N ≤ a few thousand clients, so
the O(N²) distance matrix is fine and deterministic.

The ε grid search is the selection hot path (it runs every round for
every FedLesScan cohort), so `cluster_clients` computes the pairwise
squared-distance matrix **once** and shares it across the whole grid
(`dbscan(..., d2=...)`), and scores every candidate labeling with a
vectorized Calinski–Harabasz (`calinski_harabasz_batch`): the total
scatter is a constant of the data, so only the between-cluster term is
computed per labeling, via per-dimension `bincount` group sums — no
per-cluster Python loop.  `calinski_harabasz` remains the scalar
reference the batch path is parity-tested against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

NOISE = -1


def pairwise_sq_dists(x: np.ndarray) -> np.ndarray:
    """(N, N) squared euclidean distances.  Uses the same broadcast
    subtraction as the scalar path (not the Gram-matrix identity) so the
    shared matrix is bit-identical to a per-call recomputation."""
    return np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=-1)


def dbscan(x: np.ndarray, eps: float, min_samples: int = 2,
           d2: Optional[np.ndarray] = None) -> np.ndarray:
    """Classic DBSCAN (Ester et al., 1996). Returns labels, -1 = noise.

    Deterministic: points are visited in index order and BFS (FIFO)
    expansion walks sorted neighbour lists.  `d2` optionally supplies a
    precomputed squared-distance matrix so an ε grid search pays for it
    once.
    """
    n = x.shape[0]
    labels = np.full(n, NOISE, dtype=np.int64)
    if n == 0:
        return labels
    if d2 is None:
        d2 = pairwise_sq_dists(x)
    neigh = d2 <= eps * eps  # includes self
    core = neigh.sum(axis=1) >= min_samples

    cluster = 0
    for i in range(n):
        if labels[i] != NOISE or not core[i]:
            continue
        # start a new cluster and expand it breadth-first — whole
        # frontier at once, as boolean matrix ops.  Final labels are
        # identical to the point-at-a-time walk: every point in the
        # connected core component (plus its borders) gets this cluster
        # id, and a border point shared between clusters still goes to
        # whichever cluster the index-ordered outer loop starts first.
        labels[i] = cluster
        active = np.zeros(n, dtype=bool)
        active[i] = True
        while True:
            reach = neigh[active].any(axis=0)
            reach &= labels == NOISE
            if not reach.any():
                break
            labels[reach] = cluster
            active = reach & core
            if not active.any():
                break
        cluster += 1
    return labels


def calinski_harabasz(x: np.ndarray, labels: np.ndarray) -> float:
    """Calinski–Harabasz index (variance-ratio criterion) — scalar
    reference implementation.

    Ratio of between-cluster to within-cluster dispersion, scaled by
    (N − k)/(k − 1).  Higher is better.  Returns -inf when undefined
    (k < 2 or k == N).
    """
    uniq = np.unique(labels)
    k = len(uniq)
    n = x.shape[0]
    if k < 2 or k >= n:
        return float("-inf")
    overall = x.mean(axis=0)
    ssb = 0.0  # between-group dispersion
    ssw = 0.0  # within-group dispersion
    for lab in uniq:
        pts = x[labels == lab]
        mu = pts.mean(axis=0)
        ssb += pts.shape[0] * float(np.sum((mu - overall) ** 2))
        ssw += float(np.sum((pts - mu) ** 2))
    if ssw <= 0.0:
        return float("inf")
    return (ssb / ssw) * ((n - k) / (k - 1.0))


def calinski_harabasz_batch(x: np.ndarray,
                            labelings: np.ndarray) -> np.ndarray:
    """Vectorized CH scores for a batch of labelings (E, N) → (E,).

    Per labeling, the between-cluster dispersion is assembled from
    `bincount` group sums (vectorized over clusters and dimensions);
    the within-cluster term falls out of the total-scatter identity
    ssw = T − ssb, with T computed once for the whole batch.
    """
    labelings = np.asarray(labelings)
    n, dim = x.shape
    overall = x.mean(axis=0)
    centered = x - overall
    total = float(np.sum(centered ** 2))        # T = ssb + ssw, constant
    scores = np.empty(labelings.shape[0], dtype=np.float64)
    for e, labels in enumerate(labelings):
        _, compact = np.unique(labels, return_inverse=True)
        k = int(compact.max()) + 1 if n else 0
        if k < 2 or k >= n:
            scores[e] = float("-inf")
            continue
        counts = np.bincount(compact, minlength=k).astype(np.float64)
        sums = np.stack([np.bincount(compact, weights=centered[:, d],
                                     minlength=k) for d in range(dim)],
                        axis=1)                 # (k, dim) centered sums
        ssb = float(np.sum(sums ** 2 / counts[:, None]))
        ssw = total - ssb
        if ssw <= 0.0:
            scores[e] = float("inf")
        else:
            scores[e] = (ssb / ssw) * ((n - k) / (k - 1.0))
    return scores


@dataclass
class ClusteringResult:
    labels: np.ndarray          # outliers folded into their own cluster id
    eps: float
    score: float
    n_clusters: int
    # sketch-path extras (None on the exact path): positions of the
    # sampled sketch rows in the input and their cluster labels — lets
    # callers order clusters by sketch statistics without a second
    # full-fleet pass
    sketch_pos: Optional[np.ndarray] = None
    sketch_labels: Optional[np.ndarray] = None


def _fold_noise(labels: np.ndarray) -> np.ndarray:
    """Paper: 'for simplicity, we treat outliers as a single cluster'."""
    out = labels.copy()
    if np.any(out == NOISE):
        out[out == NOISE] = out.max() + 1
    return out


def cluster_clients(x: np.ndarray, eps_grid: Optional[Sequence[float]] = None,
                    min_samples: int = 2,
                    n_eps: int = 13) -> ClusteringResult:
    """Grid-search ε for the best Calinski–Harabasz score (paper §V-C).

    The ε grid defaults to `n_eps` quantiles of the pairwise-distance
    distribution, which adapts to the current feature scale without
    extra passes.  One shared distance matrix feeds every DBSCAN run,
    and all candidate labelings are scored in a single vectorized CH
    batch.  (`n_eps` is part of the byte-parity surface — only callers
    with no parity constraint, like the fleet-scale sketch, change it.)
    """
    n = x.shape[0]
    if n == 0:
        return ClusteringResult(np.zeros(0, np.int64), 0.0, 0.0, 0)
    if n == 1:
        return ClusteringResult(np.zeros(1, np.int64), 0.0, 0.0, 1)

    d2 = pairwise_sq_dists(x)
    if eps_grid is None:
        d = np.sqrt(d2)
        pos = d[d > 0]
        if pos.size == 0:  # all identical points → one cluster
            return ClusteringResult(np.zeros(n, np.int64), 0.0, 0.0, 1)
        eps_grid = np.unique(np.quantile(pos,
                                         np.linspace(0.05, 0.95, n_eps)))

    grid = [float(eps) for eps in eps_grid if eps > 0]
    labelings = [_fold_noise(dbscan(x, eps, min_samples, d2=d2))
                 for eps in grid]
    best: Optional[ClusteringResult] = None
    if labelings:
        scores = calinski_harabasz_batch(x, np.stack(labelings))
        for eps, labels, score in zip(grid, labelings, scores):
            cand = ClusteringResult(labels, eps, float(score),
                                    len(np.unique(labels)))
            if best is None or cand.score > best.score:
                best = cand
    if best is None or best.n_clusters < 2 or not np.isfinite(best.score):
        # degenerate data (e.g. all behaviourally identical) → one cluster
        labels = np.zeros(n, np.int64)
        return ClusteringResult(labels, float(eps_grid[-1]), 0.0, 1)
    return best


SKETCH_MAX = 2048
SKETCH_SIZE = 256
_LUT_GRID = 256


def _nearest_centroid_labels(x: np.ndarray, cents: np.ndarray,
                             grid: int = _LUT_GRID) -> np.ndarray:
    """Assign every 2-D point its nearest centroid, via a grid lookup
    table instead of a k-pass scan.

    Scores use the Gram identity: argmin ||x-c||^2 over c equals
    argmax (2x.c - ||c||^2), the ||x||^2 term being constant per point.
    A dense scan pays k passes over the fleet, and k (the sketch cluster
    count) routinely hits 10+ — so instead the bounding box is cut into
    a `grid`x`grid` lattice and each *corner* is scored.  Voronoi
    regions are convex, so a cell whose four corners agree lies entirely
    inside that label's region and the whole cell resolves by table
    lookup; only points in disagreeing (decision-boundary) cells — a
    ~k/grid fraction — get the dense scan.  Total cost is one quantize
    pass + a small-table gather, independent of k.  Exact up to points
    equidistant between two centroids (either label is a nearest
    centroid).  float32 scores and int16 labels: this only runs above
    the byte-parity scale, where results are already sample-approximate.
    """
    n, k = x.shape[0], cents.shape[0]
    if k == 1:
        return np.zeros(n, np.int16)
    two_c = np.ascontiguousarray(2.0 * cents, dtype=np.float32)
    c2 = np.sum(cents ** 2, axis=1).astype(np.float32)

    xt = np.ascontiguousarray(x.T, dtype=np.float32)   # (2, n): contiguous
    x0, x1 = xt[0], xt[1]       # rows — axis-0 min/max on the interleaved
    lo0, hi0 = float(x0.min()), float(x0.max())     # (n, 2) layout is a
    lo1, hi1 = float(x1.min()), float(x1.max())     # strided crawl
    sp0 = (hi0 - lo0) or 1.0
    sp1 = (hi1 - lo1) or 1.0

    # corner lattice scores, (k, grid+1, grid+1) — separable in x/y
    g0 = np.float32(lo0) + np.float32(sp0) * \
        np.arange(grid + 1, dtype=np.float32) / np.float32(grid)
    g1 = np.float32(lo1) + np.float32(sp1) * \
        np.arange(grid + 1, dtype=np.float32) / np.float32(grid)
    sc = (two_c[:, 0, None, None] * g0[None, :, None]
          + two_c[:, 1, None, None] * g1[None, None, :])
    sc -= c2[:, None, None]
    corner = np.argmax(sc, axis=0)                  # first-wins on ties
    nw = corner[:-1, :-1]
    ok = (nw == corner[1:, :-1]) & (nw == corner[:-1, 1:]) \
        & (nw == corner[1:, 1:])
    cell = np.where(ok, nw, -1).astype(np.int16).ravel()

    ix = x0 - np.float32(lo0)
    ix *= np.float32(grid / sp0)
    iy = x1 - np.float32(lo1)
    iy *= np.float32(grid / sp1)
    ii = ix.astype(np.int32)
    jj = iy.astype(np.int32)
    np.minimum(ii, grid - 1, out=ii)    # x == hi lands on index `grid`
    np.minimum(jj, grid - 1, out=jj)
    ii *= grid
    ii += jj
    labels = cell[ii]

    rem = np.flatnonzero(labels < 0)    # boundary cells: dense scan
    if rem.size:
        s0, s1 = x0[rem], x1[rem]
        best = two_c[0, 0] * s0 + two_c[0, 1] * s1 - c2[0]
        lab = np.zeros(rem.size, np.int16)
        for j in range(1, k):
            row = two_c[j, 0] * s0 + two_c[j, 1] * s1 - c2[j]
            lab[row > best] = j         # strict '>' keeps the first
            np.maximum(best, row, out=best)
        labels[rem] = lab
    return labels


def cluster_clients_sketch(x: np.ndarray,
                           eps_grid: Optional[Sequence[float]] = None,
                           min_samples: int = 2,
                           rng: Optional[np.random.Generator] = None,
                           sketch_max: int = SKETCH_MAX,
                           sketch_size: int = SKETCH_SIZE
                           ) -> ClusteringResult:
    """`cluster_clients` with an O(sketch²) cost cap (fleet scale).

    Up to `sketch_max` participants this IS `cluster_clients` — exact
    same labels, no RNG consumed, so small-run results stay byte-stable.
    Beyond it, the ε grid search runs on a uniform behavioural sketch of
    `sketch_size` clients (drawn from `rng`) and every remaining client
    is assigned the label of its nearest sketch-cluster centroid via the
    grid-LUT broadcast — propose latency is then independent of both
    fleet size and the sketch's cluster count.
    """
    n = x.shape[0]
    if n <= sketch_max or rng is None:
        return cluster_clients(x, eps_grid, min_samples)

    pos = rng.choice(n, size=min(sketch_size, n), replace=False)
    pos.sort()                              # keep sketch in pool order
    sketch = x[pos]
    # 7 ε candidates instead of 13: the sketch re-clusters every propose
    # on a fresh sample, so a coarser grid trades negligible ε precision
    # for ~half the DBSCAN runs of the dominant fixed cost
    res = cluster_clients(sketch, eps_grid, min_samples, n_eps=7)

    k = int(res.labels.max()) + 1
    counts = np.bincount(res.labels, minlength=k).astype(np.float64)
    cents = np.stack(
        [np.bincount(res.labels, weights=sketch[:, d], minlength=k)
         for d in range(x.shape[1])], axis=1) / counts[:, None]

    labels = _nearest_centroid_labels(x, cents)
    # n_clusters reports the centroid count: every sketch cluster is a
    # centroid, and recounting occupied labels over the full fleet would
    # cost another O(n) pass for a diagnostic field
    return ClusteringResult(labels, res.eps, res.score, k,
                            sketch_pos=pos, sketch_labels=res.labels)
