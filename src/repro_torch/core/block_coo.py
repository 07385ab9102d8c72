"""Blocked COO assembly — ``MatCOOUseBlockIndices`` (torch twin of
``repro.core.block_coo``).

``preallocate_coo`` is the host symbolic phase (the PETSc COO preallocation
plan): output structure, stable sort order, duplicate-summation segments —
bitwise the reference's.  It also composes ``perm = keep[order]`` and the
per-output-block ``offsets`` into the sorted stream, so the numeric phase
``set_values_coo`` is one ``block_seg_sum`` launch reading the declaration-
order value stream through ``perm``: the sorted copy of the stream is never
written.  Negative coordinates are dropped by the plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.block_csr import (
    BlockCSR,
    coo_to_csr_structure,
    device_array,
)
from repro_torch.kernels.block_seg_sum import ops as seg_ops


@dataclasses.dataclass(frozen=True)
class BlockCOOPlan:
    """Cached symbolic assembly plan."""

    indptr: np.ndarray          # output structure
    indices: np.ndarray
    nbr: int
    nbc: int
    br: int
    bc: int
    nnzb: int                   # deduped output blocks
    keep: np.ndarray            # indices of non-ignored input coordinates
    out_idx_sorted: np.ndarray  # per sorted kept coordinate: output slot
    order: np.ndarray           # stable sort of kept coordinates
    n_input: int                # declared coordinates
    perm: np.ndarray            # (n_kept,) int32 keep[order]: stream source
    offsets: np.ndarray         # (nnzb+1,) int32 segment bounds in sorted order

    @property
    def plan_bytes(self) -> int:
        """Bytes of plan index data, counted as the reference counts them
        (the quantity the blocked COO shrinks by the block area)."""
        return (self.indptr.nbytes + self.indices.nbytes + self.keep.nbytes
                + self.out_idx_sorted.nbytes + self.order.nbytes)


def preallocate_coo(rows, cols, nbr: int, nbc: int, br: int, bc: int
                    ) -> BlockCOOPlan:
    """Symbolic phase: sort/unique block coordinates, build the scatter map.
    ``rows``/``cols`` are block coordinates of every contribution,
    duplicates allowed, negatives ignored."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if rows.shape != cols.shape:
        raise ValueError(f"rows/cols shape mismatch: {rows.shape} != "
                         f"{cols.shape}")
    keep = np.flatnonzero((rows >= 0) & (cols >= 0))
    kr, kc = rows[keep], cols[keep]
    if len(kr) and (kr.max() >= nbr or kc.max() >= nbc):
        raise ValueError(
            f"block coordinate out of range: max (row, col) = "
            f"({int(kr.max())}, {int(kc.max())}) for a {nbr} x {nbc} "
            f"block grid")
    if len(rows) >= 2 ** 31:
        raise ValueError(f"{len(rows)} coordinates exceed int32 indexing")
    indptr, indices, order, out_idx, nnzb = coo_to_csr_structure(
        kr, kc, nbr, sum_duplicates=True)
    out_idx_sorted = out_idx[order]
    offsets = np.zeros(nnzb + 1, dtype=np.int64)
    np.cumsum(np.bincount(out_idx_sorted, minlength=nnzb), out=offsets[1:])
    return BlockCOOPlan(indptr=indptr, indices=indices, nbr=nbr, nbc=nbc,
                        br=br, bc=bc, nnzb=nnzb, keep=keep,
                        out_idx_sorted=out_idx_sorted.astype(np.int32),
                        order=order.astype(np.int64), n_input=len(rows),
                        perm=keep[order].astype(np.int32),
                        offsets=offsets.astype(np.int32))


def set_values_coo(plan: BlockCOOPlan, values: torch.Tensor) -> BlockCSR:
    """Numeric phase: one device segment sum of dense block payloads.

    ``values``: ``(n_input, br, bc)`` blocks, one per declared coordinate,
    in declaration order — PETSc's MatSetValuesCOO value stream.
    """
    return BlockCSR.from_arrays(plan.indptr, plan.indices,
                                set_values_coo_data(plan, values), plan.nbc)


def set_values_coo_data(plan: BlockCOOPlan, values: torch.Tensor
                        ) -> torch.Tensor:
    """The numeric phase's ``(nnzb, br, bc)`` payload alone (the
    coefficient hot loop feeds it straight to ``gamg.recompute``): the
    ``block_seg_sum`` kernel on CUDA, its plain version on the CPU."""
    expected = (plan.n_input, plan.br, plan.bc)
    if tuple(values.shape) != expected:
        raise ValueError(f"value stream shape {tuple(values.shape)} != "
                         f"{expected} (one ({plan.br}, {plan.bc}) block per "
                         f"declared coordinate, in declaration order)")
    dev = values.device
    return seg_ops.block_seg_sum(
        values.contiguous(),
        device_array(plan, "offsets", dev, torch.int32),
        device_array(plan, "perm", dev, torch.int32))


def scalar_coo_plan_bytes(plan: BlockCOOPlan) -> int:
    """Index bytes the equivalent scalar COO plan would need: every block
    coordinate expands to ``br*bc`` scalar coordinates, each with its own
    sort and scatter entries."""
    area = plan.br * plan.bc
    n_in = len(plan.keep) * area
    nnz = plan.nnzb * area
    # indptr + indices + keep + out_idx + order at scalar granularity
    return (8 * (plan.nbr * plan.br + 1) + 4 * nnz + 8 * n_in + 4 * n_in
            + 8 * n_in)
