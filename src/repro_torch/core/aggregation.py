"""Aggregation — the greedy host coarsener (numpy twin of
``repro.core.aggregation``).

The paper keeps the aggregation graph phase on the host (Sec. 3.2): it is
irregular, serial-leaning work, built once and reused across every solve.
``greedy_aggregate`` is the classical smoothed-aggregation greedy disjoint
covering (Vanek et al.):

  pass 1  visit nodes in order; a node whose strong neighborhood is fully
          unaggregated roots a new aggregate containing the neighborhood;
  pass 2  remaining nodes join the strongest adjacent aggregate;
  pass 3  still-isolated nodes become singletons, then undersized
          aggregates (fewer block rows than needed to keep the tentative
          prolongator full column rank) merge into an adjacent aggregate.

The reference's device Luby-MIS coarsener is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.strength import StrengthGraph


@dataclasses.dataclass(frozen=True)
class Aggregation:
    node_to_agg: np.ndarray   # (n,) aggregate id per node
    n_agg: int

    def sizes(self) -> np.ndarray:
        return np.bincount(self.node_to_agg, minlength=self.n_agg)


def greedy_aggregate(graph: StrengthGraph, min_size: int = 2) -> Aggregation:
    """Greedy disjoint covering of the strong-coupling graph (host)."""
    n = graph.n
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = graph.indptr, graph.indices
    n_agg = 0
    # pass 1: root aggregates on untouched neighborhoods
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if len(nbrs) and (agg[nbrs] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nbrs] = n_agg
        n_agg += 1
    # pass 2: attach stragglers to the strongest adjacent aggregate
    weights = graph.weights
    for i in range(n):
        if agg[i] >= 0:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl]
        if len(nbrs):
            aggd = agg[nbrs] >= 0
            if aggd.any():
                w = weights[sl][aggd]
                agg[i] = agg[nbrs[aggd][np.argmax(w)]]
                continue
        # pass 3 inline: isolated node roots a singleton
        agg[i] = n_agg
        n_agg += 1
    # undersized-aggregate repair: merge into an adjacent aggregate so the
    # tentative prolongator stays full column rank (bs_f * size >= nns)
    sizes = np.bincount(agg, minlength=n_agg)
    for i in range(n):
        a = agg[i]
        if sizes[a] >= min_size:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cand = nbrs[agg[nbrs] != a] if len(nbrs) else nbrs
        if len(cand):
            target = agg[cand[0]]
            sizes[target] += sizes[a]
            sizes[a] = 0
            agg[agg == a] = target
    # compact ids
    uniq, agg = np.unique(agg, return_inverse=True)
    return Aggregation(node_to_agg=agg.astype(np.int64), n_agg=len(uniq))
