"""Tentative prolongator from the near-null space (torch twin of
``repro.core.tentative``; paper Sec. 2.2).

Each aggregate contributes ``nns`` coarse degrees of freedom (six rigid-body
modes for 3D elasticity), so P~ has rectangular ``bs_f x nns`` blocks.
Stack the near-null rows of every aggregate (zero-padded to the largest
aggregate), batched reduced QR on the device: Q gives the prolongator
blocks and R the coarse near-null space.  The sign fix makes R's diagonal
positive, so Q and R are unique and agree with the reference to rounding.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import Aggregation
from repro_torch.core.block_csr import BlockCSR


def tentative_prolongator(aggr: Aggregation, B: torch.Tensor, bs_f: int
                          ) -> Tuple[BlockCSR, torch.Tensor]:
    """Build P~ (block rows = fine nodes, block cols = aggregates) and B_c.

    B: ``(n_nodes * bs_f, nns)`` fine near-null space on the device.
    Returns (P~ with ``(bs_f x nns)`` blocks, B_c ``(n_agg*nns, nns)``).
    """
    n_nodes = len(aggr.node_to_agg)
    nns = B.shape[1]
    if B.shape[0] != n_nodes * bs_f:
        raise ValueError(f"near-null space {tuple(B.shape)} does not match "
                         f"{n_nodes} nodes of size {bs_f}")
    sizes = aggr.sizes()
    max_sz = int(sizes.max())
    if not (sizes * bs_f >= nns).all():
        raise ValueError("aggregate too small for a full-rank tentative "
                         "prolongator")
    # order nodes by aggregate; position of each node within its aggregate
    order = np.argsort(aggr.node_to_agg, kind="stable")
    agg_sorted = aggr.node_to_agg[order]
    starts = np.zeros(aggr.n_agg + 1, dtype=np.int64)
    np.add.at(starts, agg_sorted + 1, 1)
    starts = np.cumsum(starts)
    pos_in_agg = np.arange(n_nodes) - starts[agg_sorted]

    dev = B.device
    agg_t = torch.as_tensor(agg_sorted, device=dev)
    pos_t = torch.as_tensor(pos_in_agg, device=dev)
    Bn = B.reshape(n_nodes, bs_f, nns)
    padded = torch.zeros((aggr.n_agg, max_sz, bs_f, nns), dtype=B.dtype,
                         device=dev)
    padded[agg_t, pos_t] = Bn[torch.as_tensor(order, device=dev)]
    stacked = padded.reshape(aggr.n_agg, max_sz * bs_f, nns)

    Q, R = torch.linalg.qr(stacked)           # reduced
    sgn = torch.sign(torch.diagonal(R, dim1=1, dim2=2))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    Q = Q * sgn[:, None, :]
    R = R * sgn[:, :, None]

    Qb = Q.reshape(aggr.n_agg, max_sz, bs_f, nns)
    p_data = Qb[agg_t, pos_t]                 # (n_nodes, bs_f, nns) sorted
    inv = np.empty(n_nodes, dtype=np.int64)
    inv[order] = np.arange(n_nodes)
    p_data = p_data[torch.as_tensor(inv, device=dev)]
    indptr = np.arange(n_nodes + 1, dtype=np.int64)
    indices = aggr.node_to_agg.astype(np.int32)
    P = BlockCSR.from_arrays(indptr, indices, p_data.contiguous(),
                             aggr.n_agg)
    return P, R.reshape(aggr.n_agg * nns, nns)
