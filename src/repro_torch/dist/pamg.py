"""Distributed blocked operators over row slabs — halos, SpMV and PtAP
(torch twin of ``repro.dist.pamg``).

The paper's distributed hot path keeps every operand on the device and
stages the *communication plan* on the host, once.  The split follows the
reference:

host (cold, this module's ``build_*``)
    Remap every global index into (owner rank, slab-local) coordinates,
    decide the halo pattern, split each rank's rows into **interior**
    (every ELL column inside the local slab) and **boundary** (reads the
    halo window) sets, and stack the per-rank plans into ``(ndev, ...)``
    arrays — numpy for the plans, bitwise the reference's, and CPU tensors
    at the hierarchy dtype for the constant payloads.  The prolongator
    payloads a rank's Galerkin pairs touch, the off-process rows
    **P_oth** included, are gathered per rank at build time (the paper's
    cached stacked operand), so the hot PtAP moves no P.

device (hot, the ``*_apply`` / exchange functions)
    Per-rank functions over one rank's slabs (``DistGAMG.rank_args``).
    The only communication is (a) the vector halo windows of the SpMVs and
    (b) the off-process window over the A·P payload slabs in the second
    Galerkin stage, both neighbour slab exchanges
    (``repro_torch.dist.comm.RankComm.exchange``, the reference's
    ``lax.ppermute``) on mesh-ordered problems (``Halo.strategy ==
    "ppermute"``), with an all-gather where a plan's reach exceeds the
    neighbour window.  The applies run the port's kernels: ``block_spmv``
    on a ``(rpad, bs)`` slab and ``block_spmm`` on a ``(rpad, bs, k)``
    panel (the ELL indices address the halo window, so ``nbc != nbr``),
    ``block_pair_gemm`` + ``block_seg_sum`` for the pair stages (segment
    offsets derived once, at staging, from the sorted ``seg``).

    The exchange comes in two renderings sharing one sequence of
    messages: blocking (``halo_window``: exchange, wait, apply) and
    overlapped (``start_halo_exchange``, the interior rows against the
    rank's own slab while the messages are in flight,
    ``finish_halo_exchange``, the boundary rows against the window,
    ``combine_split``).  Both partials run at the full slab shape and each
    row keeps the one computed like the blocking apply's, so the two are
    bitwise equal.

Agglomerated (replicated) coarse levels: ``Halo.strategy ==
"replicated"`` marks an input vector already global on every rank (the
window is the vector, nothing moves), and the gather-boundary plans
``build_row_gather`` / ``build_payload_gather`` reassemble a global vector
or payload from one all-gather of the padded per-rank slabs.

Padding discipline: every payload slab is padded to ``max_count + 1`` so
its last slot is zero; padded plan entries gather that slot or carry a
zero constant operand, so they contribute exactly ``0.0``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR
from repro_torch.core.spgemm import SpGEMMPlan, _segment_offsets, \
    combine_pairs, pair_products
from repro_torch.dist.partition import RowPartition
from repro_torch.kernels.block_spmm import ops as spmm_ops
from repro_torch.kernels.block_spmv import ops as spmv_ops
from repro_torch.robust import inject


# ---------------------------------------------------------------------------
# Halo windows
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Halo:
    """Exchange pattern for one sharded operand axis.

    ``"replicated"`` marks an operand whose input vector is already global
    on every rank (an agglomerated level's correction): the window is the
    vector itself and no exchange happens.
    """

    width: int       # neighbour hops each side (0 = purely local)
    strategy: str    # "local" | "ppermute" | "allgather" | "replicated"
    cpad: int        # padded slab length of the exchanged axis
    ndev: int

    @property
    def window_len(self) -> int:
        if self.strategy == "allgather":
            return self.cpad * self.ndev
        if self.strategy == "replicated":
            return self.cpad
        return self.cpad * (2 * self.width + 1)

    @property
    def exchanged_slabs(self) -> int:
        """Slabs moved per rank per exchange (the halo traffic unit)."""
        if self.strategy in ("local", "replicated"):
            return 0
        return (self.ndev - 1 if self.strategy == "allgather"
                else 2 * self.width)


def make_halo(width: int, cpad: int, ndev: int) -> Halo:
    if width == 0 or ndev == 1:
        return Halo(0, "local", cpad, ndev)
    # neighbour windows beat the all-gather strictly below (ndev-1)/2 hops
    if width <= max(1, (ndev - 1) // 2):
        return Halo(width, "ppermute", cpad, ndev)
    return Halo(width, "allgather", cpad, ndev)


def window_coords(halo: Halo, owner: np.ndarray, local: np.ndarray,
                  rank: int) -> np.ndarray:
    """Host: window coordinate of (owner, slab-local) seen from ``rank``."""
    if halo.strategy == "replicated":
        return local                     # the window IS the global vector
    if halo.strategy == "allgather":
        return owner * halo.cpad + local
    return (owner - rank + halo.width) * halo.cpad + local


def center_coord(halo: Halo, rank: int) -> int:
    """An always-valid in-window coordinate for padded plan entries."""
    if halo.strategy == "replicated":
        return 0
    if halo.strategy == "allgather":
        return rank * halo.cpad
    return halo.width * halo.cpad


@dataclasses.dataclass
class PendingExchange:
    """An in-flight halo exchange: the started messages, not yet a window.
    ``parts`` holds tensors (this rank's slab, a finished all-gather) and
    ``comm.Exchange`` handles."""

    parts: tuple
    halo: Halo


def start_halo_exchange(x: torch.Tensor, halo: Halo, comm
                        ) -> PendingExchange:
    """Start the halo exchange of this rank's padded slab ``(cpad, ...)``:
    the neighbour slabs ``[-w..w]`` (one ``exchange`` per offset), the
    gathered stack (all-gather), or ``x`` itself (local / replicated —
    nothing moves).  Edge ranks receive zero slabs, which padded plan
    entries never address."""
    if halo.strategy in ("local", "replicated"):
        return PendingExchange((x,), halo)
    if halo.strategy == "allgather":
        return PendingExchange((comm.all_gather_tiled(x),), halo)
    parts = []
    for d in range(-halo.width, halo.width + 1):
        if d == 0:
            parts.append(x)
            continue
        # rank r receives slab r + d  <=>  src i sends to dst i - d
        perm = [(i, i - d) for i in range(halo.ndev)
                if 0 <= i - d < halo.ndev]
        parts.append(comm.exchange(x, perm))
    return PendingExchange(tuple(parts), halo)


def finish_halo_exchange(pend: PendingExchange) -> torch.Tensor:
    """Wait for the exchange and assemble the halo window.

    The ``"halo"`` fault site (``repro_torch.robust.inject``) fires here,
    on the assembled window, so on the split path a planted fault
    corrupts what the boundary rows read, exactly as on the blocking
    path; local and replicated strategies move no bytes and are exempt.
    """
    halo = pend.halo
    if halo.strategy in ("local", "replicated"):
        return pend.parts[0]
    if halo.strategy == "allgather":
        return inject.maybe("halo", pend.parts[0])
    parts = [p if isinstance(p, torch.Tensor) else p.wait()
             for p in pend.parts]
    return inject.maybe("halo", torch.cat(parts, dim=0))


def halo_window(x: torch.Tensor, halo: Halo, comm) -> torch.Tensor:
    """The *blocking* window: ``finish_halo_exchange(start_halo_exchange(
    ...))``, the same messages, window and fault site as the split path."""
    return finish_halo_exchange(start_halo_exchange(x, halo, comm))


# ---------------------------------------------------------------------------
# Gather-boundary plans (the sharded -> replicated switch)
# ---------------------------------------------------------------------------

def build_row_gather(part: RowPartition, pad: int) -> np.ndarray:
    """Host: window id of every global block row in an all-gathered stack
    of per-rank ``(pad, ...)`` slabs (reassembles the global vector)."""
    rows = np.arange(part.nrows)
    owner = part.owner_of(rows)
    return owner * pad + (rows - part.starts[owner])


def build_payload_gather(indptr: np.ndarray, part: RowPartition,
                         pad: int) -> np.ndarray:
    """Host: window ids reassembling a global ``(nnzb, ...)`` payload from
    all-gathered per-rank payload slabs (slab r holds the nnz of r's rows,
    padded to ``pad``)."""
    nbr = len(indptr) - 1
    rows = np.repeat(np.arange(nbr), np.diff(indptr))
    nnz_starts = indptr[part.starts]
    owner = part.owner_of(rows)
    local = np.arange(len(rows), dtype=np.int64) - nnz_starts[owner]
    return owner * pad + local


# ---------------------------------------------------------------------------
# Distributed padded-ELL operator (SpMV over slabs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistEll:
    """Per-rank stacked ELL operator: rows sharded, x read through a halo.

    ``indices`` address the *halo window* of the input vector.  Values come
    either from a constant payload staged at build time (``data``, a CPU
    tensor; P and R under the reuse model) or are gathered from the rank's
    runtime payload slab (``gather`` into A values).

    The build-time interior/boundary row split: ``int_mask`` marks, per
    rank, the slab rows whose every masked ELL column lives in the local
    slab; ``indices_local`` carries the same plan in slab-local
    coordinates (valid on interior rows; boundary and masked entries park
    at slot 0), so ``dist_ell_apply_interior`` reads the rank's own vector
    while the exchange is in flight.  Both split applies run at the full
    ``(rpad, ...)`` slab shape and ``combine_split`` selects per row.
    """

    halo: Halo
    indices: np.ndarray                 # (ndev, rpad, kmax) int32 window ids
    gather: Optional[np.ndarray]        # (ndev, rpad, kmax) into payload slab
    data: Optional[torch.Tensor]        # (ndev, rpad, kmax, br, bc) constant
    rpad: int
    kmax: int
    br: int
    bc: int
    indices_local: Optional[np.ndarray] = None  # (ndev, rpad, kmax) slab ids
    int_mask: Optional[np.ndarray] = None       # (ndev, rpad) interior rows
    int_counts: Optional[np.ndarray] = None     # (ndev,) interior rows/rank
    bnd_counts: Optional[np.ndarray] = None     # (ndev,) boundary rows/rank


def build_dist_ell(A: BlockCSR, row_part: RowPartition,
                   col_part: RowPartition, *,
                   payload_pad: Optional[int] = None,
                   const_data: Optional[torch.Tensor] = None,
                   replicated_cols: bool = False) -> DistEll:
    """Host: shard a BlockCSR's padded-ELL form over row slabs.

    Exactly one of ``payload_pad`` (runtime values: a gather map into the
    rank's padded nnz slab, whose last slot is zero) or ``const_data``
    (the global ``(nnzb, br, bc)`` payload as a CPU tensor, staged per
    rank) must be given.  ``replicated_cols=True`` declares the input
    vector replicated (an agglomerated level's global correction):
    indices stay global block coordinates and the halo is
    ``"replicated"``; only with ``const_data`` (the boundary
    prolongator).
    """
    if (payload_pad is None) == (const_data is None):
        raise ValueError("give exactly one of payload_pad and const_data")
    ndev = row_part.ndev
    plan = A.ell_plan()
    nbr, kmax = plan.indices.shape
    kmax = max(kmax, 1)
    idx = np.zeros((nbr, kmax), np.int64)
    msk = np.zeros((nbr, kmax), bool)
    gat = np.zeros((nbr, kmax), np.int64)
    idx[:, :plan.indices.shape[1]] = plan.indices
    msk[:, :plan.mask.shape[1]] = plan.mask
    gat[:, :plan.gather.shape[1]] = plan.gather
    if replicated_cols:
        if const_data is None:
            raise ValueError("replicated_cols needs a constant payload")
        halo = Halo(0, "replicated", A.nbc, ndev)
        owner = np.zeros_like(idx)
    else:
        rank_of_row = row_part.owner_of(np.arange(nbr))
        owner = col_part.owner_of(idx)
        dist = np.abs(np.where(msk, owner - rank_of_row[:, None], 0))
        width = int(dist.max()) if dist.size else 0
        halo = make_halo(width, col_part.max_count, ndev)
    rpad = max(row_part.max_count, 1)
    col_local = idx - col_part.starts[owner]

    indices = np.zeros((ndev, rpad, kmax), np.int32)
    indices_local = np.zeros((ndev, rpad, kmax), np.int32)
    gather = np.zeros((ndev, rpad, kmax), np.int64)
    data = (torch.zeros((ndev, rpad, kmax) + tuple(const_data.shape[1:]),
                        dtype=const_data.dtype)
            if const_data is not None else None)
    nnz_starts = A.indptr[row_part.starts]
    int_mask = np.zeros((ndev, rpad), bool)
    for r in range(ndev):
        sl = row_part.slab(r)
        cnt = sl.stop - sl.start
        coords = window_coords(halo, owner[sl], col_local[sl], r)
        coords = np.where(msk[sl], coords, center_coord(halo, r))
        indices[r, :cnt] = coords
        indices[r, cnt:] = center_coord(halo, r)
        # a row is interior iff every masked entry's column owner is this
        # rank (replicated windows move no bytes: every row is interior);
        # masked-out or remote entries park at slot 0 (zero operand)
        if halo.strategy == "replicated":
            is_local = np.ones((cnt, kmax), bool)
            indices_local[r, :cnt] = coords
        else:
            is_local = owner[sl] == r
            indices_local[r, :cnt] = np.where(msk[sl] & is_local,
                                              col_local[sl], 0)
        # padding rows count as interior: both paths give them 0.0
        int_mask[r, :cnt] = np.where(msk[sl], is_local, True).all(axis=1)
        int_mask[r, cnt:] = True
        if const_data is not None:
            blocks = const_data[torch.from_numpy(gat[sl])] \
                * torch.from_numpy(msk[sl])[:, :, None, None]
            data[r, :cnt] = blocks
        else:
            loc = np.where(msk[sl], gat[sl] - nnz_starts[r], payload_pad - 1)
            gather[r, :cnt] = loc
            gather[r, cnt:] = payload_pad - 1
    counts = row_part.counts
    real = np.arange(rpad)[None, :] < counts[:, None]
    int_counts = (int_mask & real).sum(axis=1)
    return DistEll(halo=halo, indices=indices,
                   gather=gather if const_data is None else None,
                   data=data, rpad=rpad, kmax=kmax, br=A.br, bc=A.bc,
                   indices_local=indices_local, int_mask=int_mask,
                   int_counts=int_counts,
                   bnd_counts=counts - int_counts)


def dist_ell_apply(indices: torch.Tensor, data: torch.Tensor,
                   x_win: torch.Tensor, accum_dtype=None) -> torch.Tensor:
    """Per-rank SpMV: ``(rpad, kmax, br, bc)`` payload against a window
    ``(win, bc)`` -> ``(rpad, br)`` on ``block_spmv``, or against a panel
    window ``(win, bc, k)`` -> ``(rpad, br, k)`` on ``block_spmm``;
    ``accum_dtype`` is the kernels' accumulator (None: the payload's).
    The window is any length: the indices address it."""
    if x_win.ndim == 2:
        return spmv_ops.block_spmv_ell(indices, data, x_win,
                                       accum_dtype=accum_dtype)
    return spmm_ops.block_spmm_ell(indices, data, x_win,
                                   accum_dtype=accum_dtype)


def dist_ell_apply_interior(indices_local: torch.Tensor, data: torch.Tensor,
                            x: torch.Tensor, accum_dtype=None
                            ) -> torch.Tensor:
    """The interior partition of the split SpMV: ``dist_ell_apply`` on the
    rank's own slab (no communication) at the full slab shape; boundary
    rows compute a throwaway value that ``combine_split`` discards."""
    return dist_ell_apply(indices_local, data, x, accum_dtype=accum_dtype)


def dist_ell_apply_boundary(indices: torch.Tensor, data: torch.Tensor,
                            x_win: torch.Tensor, accum_dtype=None
                            ) -> torch.Tensor:
    """The boundary partition: ``dist_ell_apply`` on the finished window
    (after ``finish_halo_exchange``, where the ``"halo"`` fault site
    fires); ``combine_split`` keeps its boundary rows."""
    return dist_ell_apply(indices, data, x_win, accum_dtype=accum_dtype)


def combine_split(int_mask: torch.Tensor, y_int: torch.Tensor,
                  y_bnd: torch.Tensor) -> torch.Tensor:
    """Per-row select between the two split partials: interior rows take
    the exchange-free one, boundary rows the window-fed one.  A full-shape
    select, so every kept value is the one its own apply computed."""
    m = int_mask.reshape(tuple(int_mask.shape) + (1,) * (y_int.ndim - 1))
    return torch.where(m, y_int, y_bnd)


# ---------------------------------------------------------------------------
# Distributed SpGEMM pair stages (the two Galerkin products)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistPairStage:
    """One rank-sharded numeric SpGEMM stage (pairs -> segment sum).

    ``SpGEMMPlan``'s sorted pair list restricted to the pairs whose output
    block this rank owns (a contiguous range).  The lhs operand is always
    local — A payloads for A@P, the constant R blocks for R@(AP); the rhs
    is either the build-time P_oth blocks (A@P: no hot communication) or
    a halo window over the AP payload slabs (the off-process reduction).
    Constant operands are CPU tensors at the hierarchy dtype.
    """

    halo: Optional[Halo]                # over rhs payload slabs (None=const)
    lhs_gather: Optional[np.ndarray]    # (ndev, ppad) into lhs payload slab
    lhs_data: Optional[torch.Tensor]    # (ndev, ppad, br, bk) constant
    rhs_gather: Optional[np.ndarray]    # (ndev, ppad) into rhs window
    rhs_data: Optional[torch.Tensor]    # (ndev, ppad, bk, bc) constant
    seg: np.ndarray                     # (ndev, ppad) int32 sorted out slots
    out_pad: int                        # output slab length (max nnz + 1)
    ppad: int
    # the pair-level interior/boundary split of the windowed stage 2:
    # pairs whose rhs block is rank-local vs pairs reading the window
    local_mask: Optional[np.ndarray] = None   # (ndev, ppad) local pairs
    rhs_local: Optional[np.ndarray] = None    # (ndev, ppad) into local slab
    local_counts: Optional[np.ndarray] = None  # (ndev,)
    bnd_counts: Optional[np.ndarray] = None    # (ndev,)

    def seg_offsets(self, rank: int) -> np.ndarray:
        """int32 ``(out_pad + 1,)`` bounds of rank ``rank``'s runs of
        sorted output slots: the ``block_seg_sum`` kernel's segments."""
        return _segment_offsets(self.seg[rank], self.out_pad)


def _pair_ranges(plan: SpGEMMPlan, out_part: RowPartition):
    """Per-rank contiguous [lo, hi) into the sorted pair list + slot base."""
    slot_rows = np.repeat(np.arange(plan.nbr), np.diff(plan.indptr))
    pair_rows = slot_rows[plan.out_idx]
    pair_lo = np.searchsorted(pair_rows, out_part.starts[:-1], side="left")
    pair_hi = np.searchsorted(pair_rows, out_part.starts[1:] - 1,
                              side="right")
    slot_base = plan.indptr[out_part.starts]
    return pair_lo, pair_hi, slot_base


def build_stage1(ap_plan: SpGEMMPlan, fine_part: RowPartition,
                 a_indptr: np.ndarray, p_data: torch.Tensor
                 ) -> DistPairStage:
    """A @ P with rank-cached P_oth: lhs gathered from the A slab, rhs
    constant (the P blocks each rank's pairs touch, local or not)."""
    ndev = fine_part.ndev
    lo, hi, slot_base = _pair_ranges(ap_plan, fine_part)
    counts = hi - lo
    ppad = max(int(counts.max()), 1)
    a_nnz_starts = a_indptr[fine_part.starts]
    out_counts = slot_base[1:] - slot_base[:-1]
    out_pad = int(out_counts.max()) + 1
    lhs_gather = np.zeros((ndev, ppad), np.int64)
    rhs_data = torch.zeros((ndev, ppad) + tuple(p_data.shape[1:]),
                           dtype=p_data.dtype)
    seg = np.full((ndev, ppad), out_pad - 1, np.int32)
    for r in range(ndev):
        s = slice(int(lo[r]), int(hi[r]))
        cnt = s.stop - s.start
        lhs_gather[r, :cnt] = ap_plan.pair_a[s] - a_nnz_starts[r]
        rhs_data[r, :cnt] = p_data[torch.from_numpy(ap_plan.pair_b[s])]
        seg[r, :cnt] = ap_plan.out_idx[s] - slot_base[r]
    return DistPairStage(halo=None, lhs_gather=lhs_gather, lhs_data=None,
                         rhs_gather=None, rhs_data=rhs_data, seg=seg,
                         out_pad=out_pad, ppad=ppad)


def build_stage2(ac_plan: SpGEMMPlan, coarse_part: RowPartition,
                 fine_part: RowPartition, ap_indptr: np.ndarray,
                 ap_pad: int, p_data: torch.Tensor, r_perm: np.ndarray
                 ) -> DistPairStage:
    """R @ (A P): lhs constant (R blocks from the fixed prolongator), rhs
    gathered from the halo window over the AP payload slabs — the
    off-process reduction of the distributed PtAP."""
    ndev = coarse_part.ndev
    r_data = p_data[torch.from_numpy(np.asarray(r_perm, np.int64))
                    ].transpose(1, 2)
    lo, hi, slot_base = _pair_ranges(ac_plan, coarse_part)
    counts = hi - lo
    ppad = max(int(counts.max()), 1)
    out_counts = slot_base[1:] - slot_base[:-1]
    out_pad = int(out_counts.max()) + 1
    # AP nnz -> (fine owner, slab-local offset)
    nbr_f = len(ap_indptr) - 1
    ap_rows = np.repeat(np.arange(nbr_f), np.diff(ap_indptr))
    ap_nnz_starts = ap_indptr[fine_part.starts]
    owner = fine_part.owner_of(ap_rows)
    local = np.arange(len(ap_rows), dtype=np.int64) - ap_nnz_starts[owner]
    # the per-rank ranges tile [0, npairs) contiguously
    rank_of_pair = np.repeat(np.arange(ndev), counts)
    width = 0
    if len(rank_of_pair):
        width = int(np.abs(owner[ac_plan.pair_b] - rank_of_pair).max())
    halo = make_halo(width, ap_pad, ndev)
    lhs_data = torch.zeros((ndev, ppad) + tuple(r_data.shape[1:]),
                           dtype=r_data.dtype)
    rhs_gather = np.zeros((ndev, ppad), np.int64)
    rhs_local = np.zeros((ndev, ppad), np.int64)
    seg = np.full((ndev, ppad), out_pad - 1, np.int32)
    # padded pairs select the window lane (local=False): zero lhs block x
    # the parked centre slot on both renderings
    local_mask = np.zeros((ndev, ppad), bool)
    for r in range(ndev):
        s = slice(int(lo[r]), int(hi[r]))
        cnt = s.stop - s.start
        lhs_data[r, :cnt] = r_data[torch.from_numpy(ac_plan.pair_a[s])]
        pb = ac_plan.pair_b[s]
        rhs_gather[r, :cnt] = window_coords(halo, owner[pb], local[pb], r)
        rhs_gather[r, cnt:] = center_coord(halo, r)
        seg[r, :cnt] = ac_plan.out_idx[s] - slot_base[r]
        # a pair is local iff its rhs AP block lives in this rank's slab
        is_local = (np.ones(cnt, bool)
                    if halo.strategy in ("local", "replicated")
                    else owner[pb] == r)
        rhs_local[r, :cnt] = np.where(is_local, local[pb], 0)
        local_mask[r, :cnt] = is_local
    local_counts = local_mask.sum(axis=1)
    return DistPairStage(halo=halo, lhs_gather=None, lhs_data=lhs_data,
                         rhs_gather=rhs_gather, rhs_data=None, seg=seg,
                         out_pad=out_pad, ppad=ppad,
                         local_mask=local_mask, rhs_local=rhs_local,
                         local_counts=local_counts,
                         bnd_counts=(hi - lo) - local_counts)


def dist_stage_apply(lhs: torch.Tensor, rhs: torch.Tensor,
                     seg_offsets: torch.Tensor, accum_dtype=None
                     ) -> torch.Tensor:
    """Per-rank numeric stage: ``block_pair_gemm`` pair products, then the
    ``block_seg_sum`` of each output slot's run (``seg_offsets``, int32
    ``(out_pad + 1,)``) -> ``(out_pad, br, bc)`` at ``lhs.dtype``.
    Padded pairs carry a zero operand on one side, so they add exactly
    0.0 into the (zero) last output slot."""
    return combine_pairs(pair_products(lhs, rhs, accum_dtype), seg_offsets,
                         lhs.dtype)


def dist_stage_apply_overlap(lhs: torch.Tensor, rhs_slab: torch.Tensor,
                             halo: Halo, rhs_gather: torch.Tensor,
                             rhs_local: torch.Tensor,
                             local_mask: torch.Tensor,
                             seg_offsets: torch.Tensor, comm,
                             accum_dtype=None) -> torch.Tensor:
    """The overlapped rendering of the stage-2 off-process reduction:
    start the window exchange over the rhs payload slabs, form the pair
    products straight from the rank's own slab (``rhs_local``) while the
    messages are in flight, finish the window, form them again from it,
    select per pair (``combine_split`` on the pair axis) and run the same
    segment sum as ``dist_stage_apply``.  Both product launches run at the
    full ``(ppad, ...)`` shape, so each selected product — and the sum —
    is bitwise the blocking stage's."""
    pend = start_halo_exchange(rhs_slab, halo, comm)
    prod_loc = pair_products(lhs, rhs_slab[rhs_local], accum_dtype)
    win = finish_halo_exchange(pend)
    prod_bnd = pair_products(lhs, win[rhs_gather], accum_dtype)
    prod = combine_split(local_mask, prod_loc, prod_bnd)
    return combine_pairs(prod, seg_offsets, lhs.dtype)


def build_diag_sel(indptr: np.ndarray, indices: np.ndarray,
                   part: RowPartition, payload_pad: int):
    """Host: per-rank gather of the diagonal blocks from the payload slab.

    Returns ``(sel, mask)`` stacked ``(ndev, rpad)``; rows without a stored
    diagonal (or padding rows) select the zero slot and are masked so the
    smoother substitutes the identity before inversion.
    """
    ndev = part.ndev
    nbr = len(indptr) - 1
    rows = np.repeat(np.arange(nbr), np.diff(indptr))
    is_diag = indices == rows
    sel_global = np.full(nbr, -1, np.int64)
    sel_global[rows[is_diag]] = np.flatnonzero(is_diag)
    nnz_starts = indptr[part.starts]
    rpad = max(part.max_count, 1)
    sel = np.full((ndev, rpad), payload_pad - 1, np.int64)
    mask = np.zeros((ndev, rpad), bool)
    for r in range(ndev):
        sl = part.slab(r)
        cnt = sl.stop - sl.start
        g = sel_global[sl]
        ok = g >= 0
        sel[r, :cnt] = np.where(ok, g - nnz_starts[r], payload_pad - 1)
        mask[r, :cnt] = ok
    return sel, mask
