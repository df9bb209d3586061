"""Client selection — paper Algorithm 2 (§V-C), vectorized.

Priority: rookies → clustered participants (sorted clusters, progress-offset
start) → stragglers.  Selection is deterministic given the RNG seed.

Every step is a single pass over the array-backed history store — tier
predicates are boolean masks, Eq. 2 scores come from the batched EMA
kernels in core/features.py, and the per-cluster "least-invoked first"
pick is an `argpartition` over a composite integer key
(`invocations * (N+1) + lex_rank(client_id)`), which orders exactly like
the reference `sorted(members, key=(invocations, client_id))` because
lexicographic ranks are order-isomorphic to the id strings.  RNG draws
use `rng.choice(n, ...)` index form, which consumes the identical stream
as the legacy `rng.choice(list_of_ids, ...)` calls — same-seed cohorts
are byte-identical to the dict-backed implementation
(tests/test_fleet_scale.py gates this against golden traces).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .clustering import SKETCH_MAX, cluster_clients_sketch
from .features import feature_matrix_from_store
from .history import ClientHistoryDB


@dataclass
class SelectionPlan:
    selected: List[str]
    rookies: List[str]
    cluster_clients: List[str]
    straggler_clients: List[str]
    n_clusters: int
    eps: float


def select_clients(history: ClientHistoryDB, client_ids: Sequence[str],
                   round_number: int, max_rounds: int,
                   clients_per_round: int, rng: np.random.Generator,
                   ema_alpha: float = 0.5,
                   exclude=frozenset()) -> SelectionPlan:
    """Algorithm 2 of the paper.  `exclude` drops in-flight clients from
    the pool (vectorized — pool order preserved, exactly as if the
    caller had passed a pre-filtered id list)."""
    if not hasattr(client_ids, "__len__"):
        client_ids = list(client_ids)
    idx = history.indices_for(client_ids)
    if exclude:
        lookup = history.interner.lookup
        ex = np.fromiter((lookup(c) for c in exclude), np.int64,
                         len(exclude))
        ex = ex[ex >= 0]
        if ex.size:
            idx = idx[~np.isin(idx, ex)]
    full = history.is_full_pool(idx)
    rookie_m, part_m, strag_m = history.tier_masks(idx, full_pool=full)
    if full:
        # idx is the identity permutation: mask positions ARE the store
        # indices, so flatnonzero replaces the fancy-index gathers.  The
        # straggler tier stays a lazy count — it is only materialized
        # when rookies + participants cannot fill the round, which never
        # happens at fleet scale.
        rookie_idx = np.flatnonzero(rookie_m)
        part_idx = np.flatnonzero(part_m)
        strag_idx = None
        n_strag = int(np.count_nonzero(strag_m))
    else:
        rookie_idx = idx[rookie_m]
        part_idx = idx[part_m]
        strag_idx = idx[strag_m]
        n_strag = strag_idx.size

    # Lines 3-5: rookies first — guarantees every client contributes once
    # and seeds behavioural data for future clustering.
    if rookie_idx.size >= clients_per_round:
        pos = rng.choice(rookie_idx.size, size=clients_per_round,
                         replace=False)
        chosen = history.ids_of(rookie_idx[pos])
        return SelectionPlan(chosen, chosen, [], [], 0, 0.0)

    selected_rookies = history.ids_of(rookie_idx)
    remaining = clients_per_round - len(selected_rookies)

    # Lines 6-8: how many we need from tiers 2 and 3. Stragglers are only
    # used when rookies+participants cannot fill the round.
    n_cluster_clients = min(remaining, part_idx.size)
    n_straggler_clients = min(remaining - n_cluster_clients, n_strag)
    selected_stragglers: List[str] = []
    if n_straggler_clients > 0:
        if strag_idx is None:
            strag_idx = np.flatnonzero(strag_m)
        pos = rng.choice(strag_idx.size, size=n_straggler_clients,
                         replace=False)
        selected_stragglers = history.ids_of(strag_idx[pos])

    # Lines 9-17: cluster participants on (trainingEma, missedRoundEma·maxT).
    selected_cluster: List[str] = []
    n_clusters, eps = 0, 0.0
    if n_cluster_clients > 0:
        big = part_idx.size > SKETCH_MAX
        # full pool → masked max over t_max in place of an O(|part|)
        # gather-then-reduce (same float; tier_masks guarantees part_m
        # positions are store rows there).  Passed as a thunk: max_t
        # only matters when some participant has missed a round, and
        # the feature builder skips the whole pass otherwise.
        mt = ((lambda: history.t_max_masked(part_m) or 1.0)
              if full else None)
        feats = feature_matrix_from_store(
            history, part_idx, round_number, alpha=ema_alpha,
            dtype=np.float32 if big else np.float64, max_t=mt)
        result = cluster_clients_sketch(feats, rng=rng)
        n_clusters, eps = result.n_clusters, result.eps
        labels = result.labels
        if result.sketch_labels is not None:
            # sketch path (no byte-parity constraint — the exact path
            # covers ≤ SKETCH_MAX): order clusters by the mean Eq. 2
            # total of their *sketch* members, an unbiased estimate of
            # the full-fleet mean that avoids a bincount over 10^6 rows
            sk = feats[result.sketch_pos]
            sk_tot = (sk[:, 0] + sk[:, 1]).astype(np.float64)
            k = int(result.sketch_labels.max()) + 1
            counts = np.bincount(result.sketch_labels, minlength=k)
            sums = np.bincount(result.sketch_labels, weights=sk_tot,
                               minlength=k)
            mean_arr = sums / counts    # every label occurs in its sketch
            order = [int(i) for i in np.argsort(mean_arr, kind="stable")]
        else:
            # Sort clusters by ascending mean totalEma (Eq. 2) of their
            # members.  feats already holds [trainingEma, missedEma·maxT]
            # with the same maxT, so the Eq. 2 sum reuses it
            # bit-identically instead of recomputing both EMA passes.
            totals = feats[:, 0] + feats[:, 1]
            uniq, first = np.unique(labels, return_index=True)
            first_seen = uniq[np.argsort(first)]    # first-occurrence order
            means = {int(lab): float(np.mean(totals[labels == lab]))
                     for lab in first_seen}
            order = sorted(means, key=means.__getitem__)  # stable on ties

        # Start from the cluster matching current training progress and wrap
        # (avoids always draining the fastest cluster; paper §V-C).
        progress = (0.0 if max_rounds <= 0
                    else min(1.0, round_number / max_rounds))
        start = int(progress * len(order)) % len(order)
        rotated = order[start:] + order[:start]

        # Prefer least-invoked members → balanced contributions (§VI-B);
        # client-id tiebreak via lexicographic ranks keeps the key integral.
        # Keys are gathered per drained cluster — the rotated loop usually
        # stops after one or two clusters, so building the composite key
        # for the whole participant tier would be mostly wasted work.
        lex = history.interner.lex_ranks()
        stride = np.int64(len(history.interner) + 1)

        need = n_cluster_clients
        for lab in rotated:
            if need <= 0:
                break
            members = part_idx[labels == lab]
            mkey = history.invocations_of(members) * stride + lex[members]
            if members.size <= need:
                take = members[np.argsort(mkey)]
            else:
                head = np.argpartition(mkey, need - 1)[:need]
                take = members[head[np.argsort(mkey[head])]]
            selected_cluster.extend(history.ids_of(take))
            need -= take.size

    selected = selected_rookies + selected_cluster + selected_stragglers
    return SelectionPlan(selected, selected_rookies, selected_cluster,
                         selected_stragglers, n_clusters, eps)


def select_random(client_ids: Sequence[str], clients_per_round: int,
                  rng: np.random.Generator) -> List[str]:
    """FedAvg/FedProx client selection: uniform random sample."""
    if not hasattr(client_ids, "__len__"):
        client_ids = list(client_ids)
    k = min(clients_per_round, len(client_ids))
    pos = rng.choice(len(client_ids), size=k, replace=False)
    return [client_ids[int(i)] for i in pos]
