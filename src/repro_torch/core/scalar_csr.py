"""Scalar AIJ (CSR) baseline — the format the paper compares against
(torch twin of ``repro.core.scalar_csr``).

Every ``br x bc`` block becomes ``br*bc`` scalar entries, each carrying
its own 4-byte column index (paper Sec. 2.3 byte accounting).  The module
is quarantined: nothing on the blocked coarsening path imports it
(``tests/test_torch_scalar.py`` holds that), it exists only to run the
scalar baseline the paper measures.

A scalar CSR matrix is a ``BlockCSR`` with 1x1 blocks, so the numeric
machinery (SpMV, two-phase SpGEMM, PtAP) runs on it unchanged — on the
card through the kernels' 1x1 instantiations.  The structure is built on
the host with numpy, as the reference builds it; the payload is gathered
on the payload's device through a flat map and never crosses to the
host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR


def expand_structure(A: BlockCSR):
    """Host symbolic phase of the expansion: the scalar ``(indptr,
    indices)`` and the flat gather map ``emap`` with scalar data =
    ``A.data.reshape(-1)[emap]`` (int64, bitwise the reference's)."""
    br, bc = A.br, A.bc
    counts = np.diff(A.indptr)               # blocks per block row
    # scalar row I*br + a has counts[I]*bc entries
    s_indptr = np.zeros(A.nbr * br + 1, dtype=np.int64)
    np.cumsum(np.repeat(counts, br) * bc, out=s_indptr[1:])
    blk_rows = np.repeat(np.arange(A.nbr), counts)
    k_idx = np.arange(A.nnzb)
    # scalar position of (block nnz k, a, b):
    #   s_indptr[I*br + a] + (k - indptr[I])*bc + b
    base_in_row = (k_idx - A.indptr[blk_rows]) * bc
    cols_flat = (A.indices[:, None].astype(np.int64) * bc
                 + np.arange(bc)[None, :]).astype(np.int32).reshape(-1)
    s_indices = np.empty(int(s_indptr[-1]), dtype=np.int32)
    emap = np.empty(int(s_indptr[-1]), dtype=np.int64)
    for a in range(br):
        pos = s_indptr[blk_rows * br + a] + base_in_row
        pos_flat = (pos[:, None] + np.arange(bc)[None, :]).reshape(-1)
        s_indices[pos_flat] = cols_flat
        emap[pos_flat] = (k_idx[:, None] * (br * bc) + a * bc
                          + np.arange(bc)[None, :]).reshape(-1)
    return s_indptr, s_indices, emap


def expand_bcsr(A: BlockCSR, structure=None) -> BlockCSR:
    """Expand blocked storage to scalar CSR (the AIJ conversion the paper
    eliminates from the coarsening path).  The payload is one gather on
    ``A.data``'s device; ``structure`` is ``expand_structure(A)`` where the
    caller holds it already."""
    s_indptr, s_indices, emap = expand_structure(A) if structure is None \
        else structure
    idx = torch.as_tensor(emap, device=A.data.device)
    data = A.data.reshape(-1)[idx].reshape(-1, 1, 1)
    return BlockCSR.from_arrays(s_indptr, s_indices, data, A.nbc * A.bc)


def csr_matrix_bytes(A: BlockCSR, value_bytes: int = 8,
                     index_bytes: int = 4) -> int:
    """Steady-state matrix bytes in scalar CSR (paper Sec. 4.2
    accounting)."""
    nnz = A.nnzb * A.br * A.bc
    nrows = A.nbr * A.br
    return nnz * (value_bytes + index_bytes) + (nrows + 1) * 8


def bcsr_matrix_bytes(A: BlockCSR, value_bytes: int = 8,
                      index_bytes: int = 4) -> int:
    """Steady-state matrix bytes in blocked storage: one index per
    block."""
    return (A.nnzb * (A.br * A.bc * value_bytes + index_bytes)
            + (A.nbr + 1) * 8)
