"""Strength-of-connection graph from the block format (numpy twin of
``repro.core.strength``; paper Sec. 3.2).

SA-AMG needs, before any product, (a) a scalar measure per block row and
(b) a graph whose edges are the strong couplings

    N_i(eps) = { j : |a_ij| >= eps * sqrt(a_ii * a_jj) }

GAMG's historical code demanded a scalar AIJ operator for both; here both
are computed *directly from the block storage*: one graph vertex per block
row, one candidate edge per stored block, strength weight = block Frobenius
norm.  No bs^2 expansion anywhere — the invariant the paper establishes.

As in the paper, graph construction is host work (irregular, serial-leaning,
built once and amortized across every reused solve); the norms themselves
are computed on device over the block payloads and pulled once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.block_csr import BlockCSR


@dataclasses.dataclass(frozen=True)
class StrengthGraph:
    """Symmetric strong-coupling graph over block rows (CSR, host)."""

    indptr: np.ndarray     # (n+1,)
    indices: np.ndarray    # strong neighbors, diagonal excluded
    weights: np.ndarray    # block-norm weight per edge
    n: int

    @property
    def nedges(self) -> int:
        return int(self.indices.shape[0])

    def neighbor_lists(self):
        """Python list-of-arrays view used by the greedy aggregator."""
        return [self.indices[self.indptr[i]:self.indptr[i + 1]]
                for i in range(self.n)]


def strength_graph(A: BlockCSR, theta: float = 0.08) -> StrengthGraph:
    """Build the strong-coupling graph from block norms.

    ``theta`` is the SA strength threshold (eps in the paper's Sec. 2.2);
    0.08 is standard for 3D elasticity.  The graph is symmetrized (an edge
    survives if either direction is strong) so aggregates are well-defined
    on mildly nonsymmetric operators.
    """
    if A.nbr != A.nbc:
        raise ValueError("strength graph needs a square block operator")
    n = A.nbr
    norms = A.block_norms().cpu().numpy()        # device -> host, once
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    # diagonal block norms (rows with no stored diagonal get +inf => weak)
    diag_norm = np.full(n, np.inf)
    is_diag = rows == cols
    diag_norm[rows[is_diag]] = norms[is_diag]
    off = ~is_diag
    strong = norms[off] >= theta * np.sqrt(diag_norm[rows[off]]
                                           * diag_norm[cols[off]])
    er, ec = rows[off][strong], cols[off][strong]
    ew = norms[off][strong]
    # symmetrize: union of (er,ec) and (ec,er)
    sr = np.concatenate([er, ec])
    sc = np.concatenate([ec, er])
    sw = np.concatenate([ew, ew])
    key = sr * n + sc
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    sr, sc, sw = sr[order][first], sc[order][first], sw[order][first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, sr + 1, 1)
    return StrengthGraph(indptr=np.cumsum(indptr),
                         indices=sc.astype(np.int32), weights=sw, n=n)
