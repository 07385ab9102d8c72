"""Aggregation — the greedy host coarsener and the device Luby-MIS
coarsener (torch twin of ``repro.core.aggregation``).

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
ties.

``mis_aggregate_device`` is the paper's future-work device coarsener
(MATCOARSENMISKOKKOS, Sec. 6), ``gamg.setup``'s default: deterministic
Luby rounds over integer hash weights (``luby_mis_device``), then MIS
roots claim their neighbours within two hops.  It runs with torch ops on
the device of the strength graph's ELL (``graph_to_ell``); the weights are
integer hashes, so no float tie can flip a choice and the card and the
CPU give the same aggregates bit for bit.  The reference's uint32 hash
and uint64 keys are emulated in int64 (torch's uint32 arithmetic is
incomplete): every product is reduced ``& 0xFFFFFFFF``, and the keys
``w * n + i`` fit for ``n < 2**31``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.strength import StrengthGraph
from repro_torch.kernels.backend import resolve_device


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


# ---------------------------------------------------------------------------
# Device Luby-MIS coarsener (paper Sec. 6 future work)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the product
    is split at 16 bits of ``c`` so no partial product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_weights(n: int, seed: int, device="cuda") -> torch.Tensor:
    """Deterministic per-vertex hash weights (Luby round priorities): the
    reference's uint32 hash, as int64 values in ``[0, 2**32)``.  Like the
    reference (``jnp.uint32(seed * 2654435761 + 1)``), a seed whose
    offset leaves uint32 raises."""
    device = resolve_device(device)
    off = seed * 2654435761 + 1
    if not 0 <= off <= _MASK32:
        raise OverflowError(f"seed {seed}: offset {off} out of bounds for "
                            f"uint32")
    x = (torch.arange(n, dtype=torch.int64, device=device) + off) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _luby_rounds(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                 seed: int = 0):
    """``luby_mis_device`` and the number of rounds it ran."""
    n = nbr_idx.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} vertices: the int64 keys w*n+i need "
                         f"n < 2**31")
    dev = nbr_idx.device
    idx = nbr_idx.long()
    w = _hash_weights(n, seed, dev)
    my_key = w * n + torch.arange(n, dtype=torch.int64, device=dev)
    nbr_key = w[idx] * n + idx
    # state: 0 undecided, 1 in MIS, 2 excluded
    state = torch.zeros(n, dtype=torch.int32, device=dev)
    it = 0
    while it < n + 2 and bool((state == 0).any()):
        undecided = state == 0
        # a vertex enters the MIS if it is undecided and its key beats
        # every undecided neighbour's (ties broken by index)
        n_undecided = (state[idx] == 0) & nbr_mask
        beats = torch.where(n_undecided, nbr_key > my_key[:, None], True)
        winner = undecided & beats.all(dim=1)
        state = torch.where(winner, 1, state)
        # exclude neighbours of fresh winners
        nbr_in_mis = ((state[idx] == 1) & nbr_mask).any(dim=1)
        state = torch.where((state == 0) & nbr_in_mis, 2, state)
        it += 1
    return (state == 1).to(torch.int32), it


def luby_mis_device(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                    seed: int = 0) -> torch.Tensor:
    """Maximal independent set by deterministic Luby rounds on the device
    of ``nbr_idx``.

    nbr_idx:  (n, kmax) padded neighbour lists (ELL of the strength graph)
    nbr_mask: (n, kmax) validity
    returns   (n,) int32: 1 = in the MIS, 0 = excluded

    Rounds run until no vertex is undecided (one host check a round),
    capped at ``n + 2`` as in the reference."""
    return _luby_rounds(nbr_idx, nbr_mask, seed)[0]


def _attach(in_mis: torch.Tensor, nbr_idx: torch.Tensor,
            nbr_mask: torch.Tensor) -> torch.Tensor:
    """MIS roots claim their neighbourhoods within two hops; leftovers get
    fresh ids."""
    idx = nbr_idx.long()
    root_id = torch.cumsum(in_mis, 0) - 1            # dense ids for roots
    agg = torch.where(in_mis == 1, root_id, -1)
    for _ in range(2):                                # two hops
        # an unclaimed node adopts its largest aggregated neighbour's id
        nbr_agg = torch.where(nbr_mask, agg[idx], -1)
        best = nbr_agg.max(dim=1).values
        agg = torch.where((agg < 0) & (best >= 0), best, agg)
    leftover = agg < 0
    fresh = torch.cumsum(leftover.long(), 0) - 1 + agg.max() + 1
    return torch.where(leftover, fresh, agg).to(torch.int32)


def mis_aggregate_device(nbr_idx: torch.Tensor,
                         nbr_mask: torch.Tensor) -> torch.Tensor:
    """MIS roots claim their neighbourhoods — device aggregation.

    Returns the (n,) int32 aggregate id per node (roots numbered densely),
    non-adjacent leftovers attached to a root within two hops.  The Luby
    rounds run seed 0, as the reference's do whatever ``seed`` it is
    given, so the port takes no seed here."""
    return mis_aggregate_rounds(nbr_idx, nbr_mask)[0]


def mis_aggregate_rounds(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor):
    """``mis_aggregate_device`` and the Luby rounds it took."""
    in_mis, rounds = _luby_rounds(nbr_idx, nbr_mask)
    return _attach(in_mis, nbr_idx, nbr_mask), rounds


def aggregation_from_device(agg_dev: torch.Tensor) -> Aggregation:
    """Dense aggregate ids on the host from the device coarsener's ids."""
    agg = agg_dev.cpu().numpy().astype(np.int64)
    uniq, agg = np.unique(agg, return_inverse=True)
    return Aggregation(node_to_agg=agg.astype(np.int64), n_agg=len(uniq))


def graph_to_ell(graph: StrengthGraph, device="cuda"):
    """Pad the strength graph to ELL on ``device`` (the card unless the
    caller asks for the CPU) for the device coarsener: int32 neighbour ids
    (0 in the padding) and a bool mask."""
    device = resolve_device(device)
    counts = np.diff(graph.indptr)
    kmax = max(int(counts.max()) if len(counts) else 0, 1)
    idx = np.zeros((graph.n, kmax), dtype=np.int32)
    mask = np.zeros((graph.n, kmax), dtype=bool)
    r = np.repeat(np.arange(graph.n), counts)
    within = np.arange(graph.nedges) - np.repeat(graph.indptr[:-1], counts)
    idx[r, within] = graph.indices
    mask[r, within] = True
    return (torch.as_tensor(idx).to(device),
            torch.as_tensor(mask).to(device))
