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

Pass 2's ``argmax`` decides on block-norm weights, and on a structured
mesh two aggregates' strongest edges to a straggler can tie up to
rounding: operators that differ by a few ulps may then cover differently.
``trace_tie_flips`` checks that every such difference comes from those
ties.  The reference's device Luby-MIS coarsener is queued in ROADMAP.md.
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
    return _greedy(graph, min_size)[0]


def _greedy(graph, min_size: int, follow: dict | None = None,
            tie_rtol: float = 0.0):
    """The greedy covering; also returns each pass-2 attachment's
    aggregate (pre-repair id) and, when replaying, the ties it flipped.

    ``follow`` maps a pass-2 node to another run's choice: where that
    aggregate's strongest edge lies within ``tie_rtol`` (relative) of the
    strongest edge of this graph, the node takes it instead.  The gap of
    every such flip is returned by node."""
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
    chosen, flips = {}, {}
    for i in range(n):
        if agg[i] >= 0:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs = indices[sl]
        if len(nbrs):
            aggd = agg[nbrs] >= 0
            if aggd.any():
                w = weights[sl][aggd]
                ids = agg[nbrs[aggd]]
                best = ids[np.argmax(w)]
                other = None if follow is None else follow.get(i)
                if other is not None and other != best and \
                        (ids == other).any():
                    gap = (w.max() - w[ids == other].max()) / w.max()
                    if gap <= tie_rtol:
                        best, flips[i] = other, float(gap)
                agg[i] = chosen[i] = best
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
    return (Aggregation(node_to_agg=agg.astype(np.int64), n_agg=len(uniq)),
            chosen, flips)


def trace_tie_flips(graph_a, graph_b, min_size: int,
                    tie_rtol: float) -> dict:
    """Where the greedy coverings of two strength graphs with the same
    edges differ, whether every difference comes from pass-2 ties.

    Two operators that differ by rounding give weights a few ulps apart,
    and where two aggregates' strongest edges to a straggler tie, pass 2's
    ``argmax`` may pick either.  The check replays the covering on
    ``graph_a``'s weights, letting each straggler take ``graph_b``'s
    choice where that choice ties within ``tie_rtol`` (relative, judged
    by ``graph_a``'s weights); later attachments and the undersized-
    aggregate repair then run as they will.  ``traced`` is True when the
    replay reproduces ``graph_b``'s covering node for node.  Returns the
    count of nodes whose aggregate differs, the flips the replay made and
    the largest flipped gap."""
    same_edges = (graph_a.n == graph_b.n
                  and np.array_equal(graph_a.indptr, graph_b.indptr)
                  and np.array_equal(graph_a.indices, graph_b.indices))
    agg_a = _greedy(graph_a, min_size)[0].node_to_agg
    agg_b, chosen_b, _ = _greedy(graph_b, min_size)
    out = dict(same_edges=bool(same_edges),
               differing_nodes=int((agg_a != agg_b.node_to_agg).sum()),
               flips=0, max_tie_gap=0.0, traced=False)
    if not same_edges:
        return out
    replay, _, flips = _greedy(graph_a, min_size, follow=chosen_b,
                               tie_rtol=tie_rtol)
    out.update(flips=len(flips), max_tie_gap=max(flips.values(), default=0.0),
               traced=bool(np.array_equal(replay.node_to_agg,
                                          agg_b.node_to_agg)))
    return out
