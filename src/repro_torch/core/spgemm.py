"""Two-phase rectangular-block SpGEMM, C = A @ B (torch twin of
``repro.core.spgemm``).

symbolic (torch on the operands' device, cached as numpy plans bitwise
    the reference's)
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


#: pairs one chunk of the symbolic phase expands (whole rows of A; a row
#: with more pairs is a chunk of its own).  A chunk's device temporaries
#: are under 100 bytes a pair: at this size they stay below the cold
#: set-up's own peak of device memory at m=32 and m=64.
SYMBOLIC_CHUNK_PAIRS = 1 << 21


def _work_device(*mats: BlockCSR) -> torch.device:
    """Where a symbolic phase runs: the first operand whose payload holds
    storage (structure-only operands sit on ``meta``), else the CPU."""
    return next((m.device for m in mats if m.device.type != "meta"),
                torch.device("cpu"))


def _on(a: np.ndarray, dev, dtype=torch.int64) -> torch.Tensor:
    """A host index array on ``dev`` at ``dtype`` (copied at its own
    width, widened there)."""
    return torch.as_tensor(np.asarray(a)).to(dev).to(dtype)


def _fill(out: np.ndarray, t: torch.Tensor) -> None:
    """Copy ``t`` into the host array ``out``, narrowed to its dtype on
    ``t``'s device first."""
    host = torch.from_numpy(out)
    host.copy_(t.to(host.dtype))


def _row_chunks(bounds: np.ndarray, max_work) -> list:
    """Consecutive row ranges ``(r0, r1)`` whose work ``bounds[r1] -
    bounds[r0]`` (``bounds``: the cumulative work before each row) is at
    most ``max_work``, a row above it alone; ``None``: one range."""
    n = len(bounds) - 1
    if max_work is None:
        return [(0, n)] if n else []
    out, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(bounds, bounds[r0] + max_work,
                                 side="right")) - 1
        r1 = max(r1, r0 + 1)
        out.append((r0, r1))
        r0 = r1
    return out


def _slots(skey: torch.Tensor, nbc: int, r0: int, r1: int):
    """Output slots of sorted keys ``row * nbc + col`` of rows ``[r0,
    r1)`` from their run boundaries: each key's slot (from 0), and on the
    host the slots' columns (int32) and the slots of each row."""
    new = torch.ones_like(skey, dtype=torch.bool)
    new[1:] = skey[1:] != skey[:-1]
    slot = torch.cumsum(new, 0) - 1
    uniq = skey[new]
    cols = (uniq % nbc).to(torch.int32).cpu().numpy()
    per_row = torch.bincount(uniq // nbc - r0, minlength=r1 - r0)
    return slot, cols, per_row.cpu().numpy()


def _structure_arrays(nbr: int, cols: list, per_row: list):
    """``(indptr, indices)`` of a structure built chunk by chunk."""
    indptr = np.zeros(nbr + 1, dtype=np.int64)
    np.cumsum(np.concatenate([np.zeros(0, np.int64)] + per_row),
              out=indptr[1:])
    return indptr, np.concatenate([np.zeros(0, np.int32)] + cols)


def spgemm_symbolic(A: BlockCSR, B: BlockCSR, *, device=None,
                    chunk_pairs: int | None = SYMBOLIC_CHUNK_PAIRS
                    ) -> SpGEMMPlan:
    """Symbolic phase: C structure, flat pair lists and their tiling,
    computed on ``device`` (``None``: the operands', ``_work_device``) in
    row ranges of A of at most ``chunk_pairs`` pairs (``None``: one), each
    range's pairs expanded, stably sorted by output slot and tiled on the
    device and copied into the numpy plan; the plan is the same for any
    range size.  A row's pairs meet only each other, and the expansion
    runs in A's row order, so the ranges' sorted pairs and slots follow
    one another."""
    if A.nbc != B.nbr or A.bc != B.br:
        raise ValueError(f"cannot multiply {A.nbr}x{A.nbc} blocks of "
                         f"{(A.br, A.bc)} by {B.nbr}x{B.nbc} blocks of "
                         f"{(B.br, B.bc)}")
    dev = _work_device(A, B) if device is None else torch.device(device)
    nbr, nbc = A.nbr, B.nbc
    a_ptr, a_idx = _on(A.indptr, dev), _on(A.indices, dev)
    b_ptr, b_idx = _on(B.indptr, dev), _on(B.indices, dev)
    per_a = (b_ptr[1:] - b_ptr[:-1])[a_idx]           # B-row length per A nnz
    first = torch.zeros(A.nnzb + 1, dtype=torch.int64, device=dev)
    torch.cumsum(per_a, 0, out=first[1:])             # first pair per A nnz
    row_first = first[a_ptr].cpu().numpy()            # first pair per A row
    npairs = int(row_first[-1])
    pair_a = np.empty(npairs, dtype=np.int64)
    pair_b = np.empty(npairs, dtype=np.int64)
    out_idx = np.empty(npairs, dtype=np.int32)
    cols, per_row, slot_counts, chunks = [], [], [], []
    nnzb = 0
    for r0, r1 in _row_chunks(row_first, chunk_pairs):
        n0, n1 = int(A.indptr[r0]), int(A.indptr[r1])
        p0, p1 = int(row_first[r0]), int(row_first[r1])
        cnt = per_a[n0:n1]

        def rep(v):
            return torch.repeat_interleave(v, cnt, output_size=p1 - p0)

        rows = torch.repeat_interleave(
            torch.arange(r0, r1, device=dev), a_ptr[r0 + 1:r1 + 1]
            - a_ptr[r0:r1], output_size=n1 - n0)
        pa = rep(torch.arange(n0, n1, device=dev))
        pb = torch.arange(p0, p1, device=dev) \
            + rep(b_ptr[a_idx[n0:n1]] - first[n0:n1])
        skey, order = torch.sort(rep(rows) * nbc + b_idx[pb], stable=True)
        slot, c_cols, c_rows = _slots(skey, nbc, r0, r1)
        del skey
        _fill(pair_a[p0:p1], pa[order])
        _fill(pair_b[p0:p1], pb[order])
        del pa, pb, order
        _fill(out_idx[p0:p1], slot + nnzb)
        slot_counts.append(torch.bincount(slot, minlength=len(c_cols))
                           .cpu().numpy())
        del slot
        chunks.append((p0, p1, nnzb, nnzb + len(c_cols)))
        cols.append(c_cols)
        per_row.append(c_rows)
        nnzb += len(c_cols)
    indptr, indices = _structure_arrays(nbr, cols, per_row)
    tile_a, tile_b, tile_mask, tile_seg, ident = _tile_pairs(
        pair_a, pair_b, np.concatenate([np.zeros(0, np.int64)]
                                       + slot_counts),
        chunks, A.br, A.bc, B.bc, dev)
    return SpGEMMPlan(indptr=indptr, indices=indices, nbr=nbr, nbc=nbc,
                      br=A.br, bc=B.bc, bk=A.bc, nnzb=nnzb,
                      pair_a=pair_a, pair_b=pair_b, out_idx=out_idx,
                      tile_pair_a=tile_a, tile_pair_b=tile_b,
                      tile_mask=tile_mask, tile_seg=tile_seg,
                      tile_identity=ident)


def _choose_tile_width(counts: np.ndarray, br: int, bk: int, bc: int):
    """Pick the tile width from the pair histogram by modeled traffic;
    returns ``(width, tile rows)``.

    Width k costs ``k * sum(ceil(c/k))`` operand cells (each moving one
    (br, bk) + one (bk, bc) block) plus, whenever any slot splits, a write +
    read of one (br, bc) partial per tile row.  Minimizing this trades ELL
    padding against the partial combine; skewed histograms (the R@AP stage)
    get a small k with row splits, tight ones get kmax and a true single
    pass.
    """
    kmax = int(counts.max())
    nnzb = int((counts > 0).sum())
    if kmax <= 1:
        return max(kmax, 1), nnzb
    hist = np.bincount(np.minimum(counts, kmax))
    vals = np.arange(len(hist), dtype=np.int64)
    operand = br * bk + bk * bc
    partial = 2 * br * bc
    if kmax <= 512:
        cands = np.arange(1, kmax + 1)
    else:  # pathological width: probe the histogram quantiles only
        qs = np.percentile(counts[counts > 0],
                           [25, 50, 75, 90, 95, 99]).astype(np.int64)
        cands = np.unique(np.clip(np.concatenate([qs, [kmax]]), 1, kmax))
    best_k, best_rows, best_cost = kmax, None, None
    for k in cands:
        nrows = int((hist * -(-vals // k)).sum())
        cost = k * nrows * operand + (partial * nrows
                                      if nrows > nnzb else 0)
        if best_cost is None or cost < best_cost:
            best_cost, best_k, best_rows = cost, int(k), nrows
    return best_k, best_rows


def _tile_pairs(pair_a: np.ndarray, pair_b: np.ndarray, counts: np.ndarray,
                chunks: list, br: int, bk: int, bc: int, dev):
    """Re-pack the sorted pair list into the fixed-width tiled layout.

    Rows of ``pair_kmax`` zero-padded pair slots; an output block with more
    pairs than the width gets consecutive rows (``tile_seg`` maps row ->
    slot).  Padded cells gather block 0 and are masked out (the numeric
    phase zeroes the gathered lhs, so padding contributes exactly 0.0).
    ``counts`` holds the pairs of each slot (at least one); each chunk
    ``(p0, p1, s0, s1)`` of the symbolic phase, pairs ``[p0, p1)`` of
    slots ``[s0, s1)``, fills its own run of tile rows on ``dev``.
    """
    nnzb = len(counts)
    if not nnzb:
        return (np.zeros((0, 0), np.int32), np.zeros((0, 0), np.int32),
                np.zeros((0, 0), bool), np.zeros(0, np.int32), True)
    width, nrows = _choose_tile_width(counts, br, bk, bc)
    tile_a = np.zeros((nrows, width), dtype=np.int32)
    tile_b = np.zeros((nrows, width), dtype=np.int32)
    mask = np.zeros((nrows, width), dtype=bool)
    seg = np.empty(nrows, dtype=np.int32)
    flat = [t.reshape(-1) for t in (tile_a, tile_b, mask)]
    t0 = 0                                       # tile rows filled so far
    for p0, p1, s0, s1 in chunks:
        c = _on(counts[s0:s1], dev)
        rows_per_slot = -torch.div(-c, width, rounding_mode="floor")
        nr = int(rows_per_slot.sum())
        row_start = torch.cumsum(rows_per_slot, 0) - rows_per_slot
        pair_start = torch.cumsum(c, 0) - c + p0
        # pair p of slot s lands at row_start[s] * width + (p - pair_start[s])
        pos = torch.arange(p0, p1, device=dev) + torch.repeat_interleave(
            row_start * width - pair_start, c, output_size=p1 - p0)
        cells = slice(t0 * width, (t0 + nr) * width)
        for out, src in zip(flat, (pair_a, pair_b)):
            t = torch.zeros(nr * width, dtype=torch.int32, device=dev)
            t[pos] = _on(src[p0:p1], dev, torch.int32)
            _fill(out[cells], t)
        m = torch.zeros(nr * width, dtype=torch.bool, device=dev)
        m[pos] = True
        _fill(flat[2][cells], m)
        _fill(seg[t0:t0 + nr], torch.repeat_interleave(
            torch.arange(s0, s1, dtype=torch.int32, device=dev),
            rows_per_slot, output_size=nr))
        t0 += nr
    return tile_a, tile_b, mask, seg, nrows == nnzb


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
        prod = pair_products(lhs, rhs, accum_dtype)
    else:
        c = backend.contract_dtype(acc)
        prod = torch.einsum("pij,pjk->pik", lhs.to(c),
                            rhs.to(c)).to(acc).contiguous()
    return combine_pairs(prod, device_array(plan, "pair_offsets", dev,
                                            torch.int32), a_data.dtype)


def pair_products(lhs: torch.Tensor, rhs: torch.Tensor,
                  accum_dtype=None) -> torch.Tensor:
    """The pairs path's ``(npairs, br, bc)`` products of gathered operands
    on the ``block_pair_gemm`` kernel, kept at the accumulator until they
    are combined: bf16 operands are widened in the kernel, others cast up
    first (``repro_torch.dist.pamg``'s stage applies share it)."""
    acc = backend.accumulator(lhs.dtype, accum_dtype)
    if lhs.dtype == torch.bfloat16 and acc == torch.float32:
        return pair_ops.block_pair_gemm(lhs, rhs, accum_dtype=acc,
                                        out_dtype=acc)
    return pair_ops.block_pair_gemm(lhs.to(acc), rhs.to(acc))


def combine_pairs(prod: torch.Tensor, offsets: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Sorted segment sums of pair products on the ``block_seg_sum``
    kernel (segment ``s`` is positions ``offsets[s]:offsets[s+1]``), at
    the products' contraction dtype, rounded once to ``out_dtype``."""
    return seg_ops.block_seg_sum(
        prod, offsets,
        accum_dtype=backend.contract_dtype(prod.dtype)).to(out_dtype)


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


def spgemm_numeric(plan: SpGEMMPlan, A: BlockCSR, B: BlockCSR, **kw
                   ) -> BlockCSR:
    """Numeric phase on the operands' payloads -> ``C`` (``path=`` and
    ``accum_dtype=`` flow to ``spgemm_numeric_data``)."""
    data = spgemm_numeric_data(plan, A.data, B.data, **kw)
    return BlockCSR.from_arrays(plan.indptr, plan.indices, data, plan.nbc)


def spgemm(A: BlockCSR, B: BlockCSR, **kw) -> BlockCSR:
    """One-shot product (symbolic + numeric); hot paths cache the plan."""
    return spgemm_numeric(spgemm_symbolic(A, B), A, B, **kw)


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


def block_axpy_symbolic(X: BlockCSR, Y: BlockCSR, *,
                        chunk_blocks: int | None = SYMBOLIC_CHUNK_PAIRS
                        ) -> BlockAXPYPlan:
    """Union structure and both operands' slots, on the operands' device
    (``_work_device``), in row ranges of at most ``chunk_blocks`` blocks
    of X and Y together (``None``: one range), as ``spgemm_symbolic``."""
    if (X.nbr, X.nbc, X.br, X.bc) != (Y.nbr, Y.nbc, Y.br, Y.bc):
        raise ValueError("block AXPY operands differ in shape")
    dev = _work_device(X, Y)
    nbr, nbc = X.nbr, X.nbc
    slots = (np.empty(X.nnzb, dtype=np.int64),
             np.empty(Y.nnzb, dtype=np.int64))
    cols, per_row = [], []
    nnzb = 0
    for r0, r1 in _row_chunks(X.indptr + Y.indptr, chunk_blocks):
        keys, spans = [], []
        for M in (X, Y):
            lo, hi = int(M.indptr[r0]), int(M.indptr[r1])
            rows = torch.repeat_interleave(
                torch.arange(r0, r1, device=dev),
                _on(np.diff(M.indptr[r0:r1 + 1]), dev), output_size=hi - lo)
            keys.append(rows * nbc + _on(M.indices[lo:hi], dev))
            spans.append((lo, hi))
        skey, order = torch.sort(torch.cat(keys))
        slot, c_cols, c_rows = _slots(skey, nbc, r0, r1)
        inv = torch.empty_like(slot)
        inv[order] = slot + nnzb
        k = 0
        for out, (lo, hi) in zip(slots, spans):
            _fill(out[lo:hi], inv[k:k + hi - lo])
            k += hi - lo
        cols.append(c_cols)
        per_row.append(c_rows)
        nnzb += len(c_cols)
    indptr, indices = _structure_arrays(nbr, cols, per_row)
    return BlockAXPYPlan(indptr=indptr, indices=indices, nbr=nbr, nbc=nbc,
                         x_slot=slots[0], y_slot=slots[1], nnzb=nnzb)


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


def block_axpy(alpha, X: BlockCSR, Y: BlockCSR) -> BlockCSR:
    """C = alpha*X + Y, natively blocked, no scalar conversion."""
    plan = block_axpy_symbolic(X, Y)
    data = block_axpy_numeric_data(plan, alpha, X.data, Y.data)
    return BlockCSR.from_arrays(plan.indptr, plan.indices, data, plan.nbc)
