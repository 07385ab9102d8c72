"""Two-phase rectangular-block SpGEMM, C = A @ B (torch twin of
``repro.core.spgemm``).

symbolic (host numpy, cached — bitwise the reference's)
    The flat pair list (pair ``p`` adds ``A.data[pair_a[p]] @
    B.data[pair_b[p]]`` to output block ``out_idx[p]``, sorted by output
    slot) and its tiled ELL-of-pairs re-pack: rows of ``pair_kmax``
    zero-padded pair slots of one output block; blocks with more pairs span
    consecutive rows (``tile_seg``).

numeric (device), ``path=`` resolved by ``repro_torch.kernels.backend``:
    "fused"      (default) the ``fused_pair_gemm`` kernel gathers the
                 operand blocks through the tile plan and contracts each
                 tile row in registers; when rows split
                 (``tile_identity`` False) the O(nnzb) row partials are
                 combined by the ``block_seg_sum`` kernel.  Neither the
                 gathered operands nor the ``(npairs, br, bc)`` products
                 are built.
    "pairs"      the unfused ablation path (paper's PtAP ablation,
                 ``benchmarks/table3_ptap_ablation.py`` in the reference):
                 gathered ``(npairs, br, bk)`` / ``(npairs, bk, bc)``
                 operands, the ``block_pair_gemm`` kernel's
                 ``(npairs, br, bc)`` products, then the ``block_seg_sum``
                 kernel over ``out_idx``.
    "reference"  gathered operands, einsum pair products and a sorted
                 segment sum over ``out_idx`` (the reference's CPU
                 default order); CPU only — raises on CUDA payloads.

``accum_dtype`` is the reference's accumulator on every path (None: the
payload's; the output is always at ``a_data.dtype``): the fused kernel's
output is rounded to the payload dtype and the row-split combine sums it
at the accumulator; the pairs path contracts and combines at the
accumulator and rounds once (``repro.core.spgemm``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR, device_array
from repro_torch.kernels import backend
from repro_torch.kernels.block_pair_gemm import ops as pair_ops
from repro_torch.kernels.block_seg_sum import ops as seg_ops
from repro_torch.kernels.fused_pair_gemm import ops as gemm_ops


def _segment_offsets(seg: np.ndarray, nseg: int) -> np.ndarray:
    """int32 ``(nseg+1,)`` bounds of the runs of sorted segment ids."""
    offsets = np.zeros(nseg + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=nseg), out=offsets[1:])
    return offsets.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SpGEMMPlan:
    """Cached symbolic phase of C = A @ B (structure-only function)."""

    indptr: np.ndarray       # C structure
    indices: np.ndarray
    nbr: int                 # C block rows
    nbc: int                 # C block cols
    br: int                  # C block shape
    bc: int
    bk: int                  # inner (contracted) block dim: A.bc == B.br
    nnzb: int
    pair_a: np.ndarray       # (npairs,) indices into A.data
    pair_b: np.ndarray       # (npairs,) indices into B.data
    out_idx: np.ndarray      # (npairs,) sorted output slot per pair
    tile_pair_a: np.ndarray  # (tile_rows, pair_kmax) int32 into A.data
    tile_pair_b: np.ndarray  # (tile_rows, pair_kmax) int32 into B.data
    tile_mask: np.ndarray    # (tile_rows, pair_kmax) bool, False on padding
    tile_seg: np.ndarray     # (tile_rows,) int32 sorted output slot per row
    tile_identity: bool      # tile_seg == arange(nnzb): no combine needed

    @property
    def npairs(self) -> int:
        return int(self.pair_a.shape[0])

    @property
    def pair_kmax(self) -> int:
        return int(self.tile_pair_a.shape[1])

    @property
    def tile_rows(self) -> int:
        return int(self.tile_pair_a.shape[0])

    @property
    def pair_offsets(self) -> np.ndarray:
        """Segment bounds of the sorted pair list (reference path)."""
        return _segment_offsets(self.out_idx, self.nnzb)

    @property
    def tile_offsets(self) -> np.ndarray:
        """Segment bounds of the tile rows (row-split combine)."""
        return _segment_offsets(self.tile_seg, self.nnzb)


def spgemm_symbolic(A: BlockCSR, B: BlockCSR) -> SpGEMMPlan:
    """Host symbolic phase: C structure + flat pair lists."""
    if A.nbc != B.nbr or A.bc != B.br:
        raise ValueError(f"cannot multiply {A.nbr}x{A.nbc} blocks of "
                         f"{(A.br, A.bc)} by {B.nbr}x{B.nbc} blocks of "
                         f"{(B.br, B.bc)}")
    nbr, nbc = A.nbr, B.nbc
    a_counts = np.diff(A.indptr)
    a_rows = np.repeat(np.arange(nbr, dtype=np.int64), a_counts)
    j = A.indices.astype(np.int64)                    # mid index per A nnz
    b_counts = np.diff(B.indptr)
    per_a = b_counts[j]                               # B-row length per A nnz
    total = int(per_a.sum())
    pair_a = np.repeat(np.arange(A.nnzb, dtype=np.int64), per_a)
    starts = np.repeat(B.indptr[j], per_a)
    csum = np.zeros(A.nnzb + 1, dtype=np.int64)
    np.cumsum(per_a, out=csum[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(csum[:-1], per_a)
    pair_b = starts + within
    pair_row = np.repeat(a_rows, per_a)
    pair_col = B.indices[pair_b].astype(np.int64)
    # unique (row, col) -> C structure; sort pairs by output slot
    key = pair_row * nbc + pair_col
    order = np.argsort(key, kind="stable")
    skey = key[order]
    uniq, inv = np.unique(skey, return_inverse=True)
    u_rows = uniq // nbc
    u_cols = (uniq % nbc).astype(np.int32)
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr)
    pair_a_s = pair_a[order]
    pair_b_s = pair_b[order]
    out_idx = inv.astype(np.int32)
    tile_a, tile_b, tile_mask, tile_seg, ident = _tile_pairs(
        pair_a_s, pair_b_s, out_idx, len(uniq), A.br, A.bc, B.bc)
    return SpGEMMPlan(indptr=indptr, indices=u_cols, nbr=nbr, nbc=nbc,
                      br=A.br, bc=B.bc, bk=A.bc, nnzb=len(uniq),
                      pair_a=pair_a_s, pair_b=pair_b_s, out_idx=out_idx,
                      tile_pair_a=tile_a, tile_pair_b=tile_b,
                      tile_mask=tile_mask, tile_seg=tile_seg,
                      tile_identity=ident)


def _choose_tile_width(counts: np.ndarray, br: int, bk: int, bc: int) -> int:
    """Pick the tile width from the pair histogram by modeled traffic.

    Width k costs ``k * sum(ceil(c/k))`` operand cells (each moving one
    (br, bk) + one (bk, bc) block) plus, whenever any slot splits, a write +
    read of one (br, bc) partial per tile row.  Minimizing this trades ELL
    padding against the partial combine; skewed histograms (the R@AP stage)
    get a small k with row splits, tight ones get kmax and a true single
    pass.
    """
    kmax = int(counts.max())
    if kmax <= 1:
        return max(kmax, 1)
    hist = np.bincount(np.minimum(counts, kmax))
    vals = np.arange(len(hist), dtype=np.int64)
    nnzb = int((counts > 0).sum())
    operand = br * bk + bk * bc
    partial = 2 * br * bc
    if kmax <= 512:
        cands = np.arange(1, kmax + 1)
    else:  # pathological width: probe the histogram quantiles only
        qs = np.percentile(counts[counts > 0],
                           [25, 50, 75, 90, 95, 99]).astype(np.int64)
        cands = np.unique(np.clip(np.concatenate([qs, [kmax]]), 1, kmax))
    best_k, best_cost = kmax, None
    for k in cands:
        nrows = int((hist * -(-vals // k)).sum())
        cost = k * nrows * operand + (partial * nrows
                                      if nrows > nnzb else 0)
        if best_cost is None or cost < best_cost:
            best_cost, best_k = cost, int(k)
    return best_k


def _tile_pairs(pair_a: np.ndarray, pair_b: np.ndarray, out_idx: np.ndarray,
                nnzb: int, br: int, bk: int, bc: int):
    """Re-pack the sorted pair list into the fixed-width tiled layout.

    Rows of ``pair_kmax`` zero-padded pair slots; an output block with more
    pairs than the width gets consecutive rows (``tile_seg`` maps row ->
    slot).  Padded cells gather block 0 and are masked out (the numeric
    phase zeroes the gathered lhs, so padding contributes exactly 0.0).
    """
    npairs = len(out_idx)
    if not npairs or not nnzb:
        return (np.zeros((nnzb, 0), np.int32), np.zeros((nnzb, 0), np.int32),
                np.zeros((nnzb, 0), bool),
                np.arange(nnzb, dtype=np.int32), True)
    counts = np.bincount(out_idx, minlength=nnzb).astype(np.int64)
    width = _choose_tile_width(counts, br, bk, bc)
    rows_per_slot = -(-counts // width)          # ceil; 0 for empty slots
    nrows = int(rows_per_slot.sum())
    row_start = np.zeros(nnzb + 1, dtype=np.int64)
    np.cumsum(rows_per_slot, out=row_start[1:])
    seg = np.repeat(np.arange(nnzb, dtype=np.int32), rows_per_slot)
    starts = np.zeros(nnzb + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    within = np.arange(npairs, dtype=np.int64) - starts[out_idx]
    r_idx = row_start[out_idx] + within // width
    c_idx = within % width
    tile_a = np.zeros((nrows, width), dtype=np.int32)
    tile_b = np.zeros((nrows, width), dtype=np.int32)
    mask = np.zeros((nrows, width), dtype=bool)
    tile_a[r_idx, c_idx] = pair_a
    tile_b[r_idx, c_idx] = pair_b
    mask[r_idx, c_idx] = True
    ident = nrows == nnzb and bool(np.array_equal(
        seg, np.arange(nnzb, dtype=np.int32)))
    return tile_a, tile_b, mask, seg, ident


def spgemm_numeric_data(plan: SpGEMMPlan, a_data: torch.Tensor,
                        b_data: torch.Tensor, *, path: str | None = None,
                        accum_dtype=None) -> torch.Tensor:
    """Device numeric phase -> C.data, a pure function of the plan and the
    values.  ``path`` is "fused" | "pairs" | "reference" (``None``: the
    ``REPRO_TORCH_SPGEMM_PATH`` knob, default "fused"); "reference" is
    CPU-only.  ``accum_dtype``: see the module docstring."""
    dev = a_data.device
    path = backend.resolve_spgemm_path(dev, path)
    a_data, b_data = a_data.contiguous(), b_data.contiguous()
    if path == "fused":
        return _fused_numeric(plan, a_data, b_data, accum_dtype)
    acc = backend.accumulator(a_data.dtype, accum_dtype)
    lhs = a_data[device_array(plan, "pair_a", dev)]     # (npairs, br, bk)
    rhs = b_data[device_array(plan, "pair_b", dev)]     # (npairs, bk, bc)
    if path == "pairs":
        # the products stay at the accumulator until they are combined:
        # bf16 operands are widened in the kernel, others cast up first
        if lhs.dtype == torch.bfloat16 and acc == torch.float32:
            prod = pair_ops.block_pair_gemm(lhs, rhs, accum_dtype=acc,
                                            out_dtype=acc)
        else:
            prod = pair_ops.block_pair_gemm(lhs.to(acc), rhs.to(acc))
    else:
        c = backend.contract_dtype(acc)
        prod = torch.einsum("pij,pjk->pik", lhs.to(c),
                            rhs.to(c)).to(acc).contiguous()
    return seg_ops.block_seg_sum(
        prod, device_array(plan, "pair_offsets", dev, torch.int32),
        accum_dtype=backend.contract_dtype(acc)).to(a_data.dtype)


def _fused_numeric(plan: SpGEMMPlan, a_data: torch.Tensor,
                   b_data: torch.Tensor, accum_dtype=None) -> torch.Tensor:
    """One kernel over the tiled plan (operands gathered in the kernel),
    then, only where rows split, the O(nnzb) partial combine at the
    accumulator."""
    dev = a_data.device
    out = gemm_ops.fused_pair_gemm(
        a_data, b_data,
        device_array(plan, "tile_pair_a", dev, torch.int32),
        device_array(plan, "tile_pair_b", dev, torch.int32),
        device_array(plan, "tile_mask", dev, torch.bool),
        accum_dtype=accum_dtype)
    if plan.tile_identity:
        return out
    acc = backend.contract_dtype(backend.accumulator(out.dtype, accum_dtype))
    return seg_ops.block_seg_sum(
        out, device_array(plan, "tile_offsets", dev, torch.int32),
        accum_dtype=acc)


# ---------------------------------------------------------------------------
# Native block AXPY (union sparsity, no scalar conversion).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockAXPYPlan:
    """Union-sparsity plan for C = alpha*X + Y with different patterns.

    PETSc's MatAXPY falls back to a scalar conversion when the operands do
    not share a sparsity pattern — the one residual conversion in the
    paper's cold path.  This plan makes it native: a one-time symbolic union
    plus numeric scatter of both operands.
    """
    indptr: np.ndarray
    indices: np.ndarray
    nbr: int
    nbc: int
    x_slot: np.ndarray     # output slot of every X block
    y_slot: np.ndarray     # output slot of every Y block
    nnzb: int


def block_axpy_symbolic(X: BlockCSR, Y: BlockCSR) -> BlockAXPYPlan:
    if (X.nbr, X.nbc, X.br, X.bc) != (Y.nbr, Y.nbc, Y.br, Y.bc):
        raise ValueError("block AXPY operands differ in shape")
    nbr, nbc = X.nbr, X.nbc
    xr = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(X.indptr))
    yr = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(Y.indptr))
    keys = np.concatenate([xr * nbc + X.indices, yr * nbc + Y.indices])
    uniq, inv = np.unique(keys, return_inverse=True)
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.add.at(indptr, (uniq // nbc) + 1, 1)
    return BlockAXPYPlan(indptr=np.cumsum(indptr),
                         indices=(uniq % nbc).astype(np.int32),
                         nbr=nbr, nbc=nbc,
                         x_slot=inv[:X.nnzb].astype(np.int64),
                         y_slot=inv[X.nnzb:].astype(np.int64),
                         nnzb=len(uniq))


def block_axpy_numeric_data(plan: BlockAXPYPlan, alpha,
                            x_data: torch.Tensor,
                            y_data: torch.Tensor) -> torch.Tensor:
    """``alpha*X + Y`` on the union structure.  Each operand's blocks land
    in distinct slots, so plain index assignment places them (no
    atomics)."""
    dev = x_data.device
    out = torch.zeros((plan.nnzb,) + tuple(x_data.shape[1:]),
                      dtype=x_data.dtype, device=dev)
    xs = device_array(plan, "x_slot", dev)
    ys = device_array(plan, "y_slot", dev)
    out[xs] = alpha * x_data
    out[ys] = out[ys] + y_data
    return out
