"""Distributed GAMG: the hot recompute and solve over row slabs, one process
per rank (torch twin of ``repro.dist.solver``).

``build_dist_gamg(setupd, ndev)`` is the cold, host-side staging pass: it
takes the single-device ``GAMGSetup`` (global structure and plans) and
remaps every plan into per-rank slabs, the off-process prolongator rows
(P_oth) of the first Galerkin stage included.  ``make_dist_solver`` is the
hot path of one rank: given that rank's slabs (``DistGAMG.rank_args``) and
a ``repro_torch.dist.comm.RankComm``, one call recomputes the hierarchy
and runs the AMG-preconditioned CG:

    recompute   chained distributed PtAP (stage 1 local thanks to the
                cached P_oth operand; stage 2's off-process reduction is a
                neighbour window over the A·P payload slabs), smoother data
                (pbjacobi inverses, a distributed power iteration for the
                Chebyshev bound), the coarse Cholesky (replicated).
    solve       CG with rank-reduced dots (``RankComm.allreduce_sum``: the
                same bits on every rank, so every rank takes the same exit
                branch) and halo windows for every level SpMV.

The reference's ``shard_map`` body becomes plain per-rank code:
``lax.ppermute`` is ``RankComm.exchange``, ``lax.psum`` a rank-ordered
reduction, ``lax.all_gather(tiled=True)`` ``RankComm.all_gather_tiled``.
Every rank runs the same Python on data that agrees where it must, so the
collectives line up without a schedule of their own.

Level placement (PETSc GAMG's process reduction): levels above the
``coarse_eq_limit`` equations-per-rank threshold stay slab-sharded; levels
at or below it are agglomerated into a replicated tail that every rank
runs redundantly through the port's single-device functions
(``gamg.level_state``, ``ptap_numeric_data``, ``vcycle.apply_smoother``,
``apply_ell`` / ``apply_restriction``), so the tail launches the same
``fused_smoother``, ``fused_pair_gemm`` and ``block_spmv`` kernels as the
single-device path.  The switch costs one all-gather per V-cycle (the fine
residual) and one per recompute (the first replicated payload); the
prolongation back moves nothing (a ``"replicated"`` halo).

Halo schedule: every sharded operator apply routes through ``_rank_spmv``,
blocking or overlapped (the interior rows while the exchange is in
flight) per ``REPRO_TORCH_OVERLAP`` (``kernels.backend.resolve_overlap``,
bound at the solver's first call as the reference binds it at trace time);
the two are bitwise equal, and the stage-2 reduction overlaps the same way
at pair granularity.  Slab levels smooth with the unfused recurrences
(``D^-1`` by einsum), as the reference's ``_rank_smooth`` does.

The coefficient front door (``build_dist_assembly`` /
``make_dist_coeff_solver``): each rank receives two per-element
coefficient slabs (``DistAssembly.scatter_fields``), never a value
stream, computes its elements' stiffness blocks (``fem.device_stiffness
.element_value_stream``) and sums its contiguous slice of the global
sorted scatter-sum with one ``block_seg_sum`` launch, then runs the
recompute and the CG above.  With ``warm_start=True`` a time march feeds
each rank's x slab straight back in as the next step's x0 slab.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR, BlockELL, \
    EllTransposePlan, device_array
from repro_torch.core.gamg import GAMGSetup, LevelSetup, _at, \
    coarse_cholesky, jittered_cholesky, level_state, restriction_bcsr
from repro_torch.core.krylov import pcg
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.core.ptap import ptap_numeric_data
from repro_torch.core.smooth import invert_diag_blocks
from repro_torch.core.spgemm import _segment_offsets
from repro_torch.core.spmv import apply_ell, apply_ell_t
from repro_torch.core.vcycle import LevelState, apply_restriction, \
    apply_smoother, chebyshev_recurrence, coarse_solve, pbjacobi_recurrence
from repro_torch.dist.pamg import (
    DistEll,
    DistPairStage,
    build_diag_sel,
    build_dist_ell,
    build_payload_gather,
    build_row_gather,
    build_stage1,
    build_stage2,
    combine_split,
    dist_ell_apply,
    dist_ell_apply_boundary,
    dist_ell_apply_interior,
    dist_stage_apply,
    dist_stage_apply_overlap,
    finish_halo_exchange,
    halo_window,
    start_halo_exchange,
)
from repro_torch.dist.partition import ProcessMesh, RowPartition, as_mesh, \
    partition_rows
from repro_torch.fem.device_stiffness import element_value_stream
from repro_torch.kernels import backend
from repro_torch.kernels.block_seg_sum import ops as seg_ops
from repro_torch.multirhs.block_krylov import block_pcg
from repro_torch.obs import trace as obs_trace
from repro_torch.robust import inject

#: Default agglomeration threshold, in equations per rank (the PETSc
#: ``-pc_gamg_process_eq_limit`` default): a level whose global equation
#: count divided by ``ndev`` is at or below this leaves the fully-sharded
#: path.  ``coarse_eq_limit=0`` disables agglomeration entirely.
DEFAULT_COARSE_EQ_LIMIT = 50


# ---------------------------------------------------------------------------
# Cold build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistLevel:
    """Per-level rank-sharded plans (host, stacked ``(ndev, ...)``).

    ``p_op``/``r_op`` are ``None`` on the last sharded level when a
    replicated tail follows — the transfers across the placement boundary
    live in ``DistSwitch`` instead.
    """

    a_op: DistEll
    p_op: Optional[DistEll]
    r_op: Optional[DistEll]
    stage1: DistPairStage
    stage2: DistPairStage
    diag_sel: np.ndarray
    diag_mask: np.ndarray
    row_mask: np.ndarray          # (ndev, rpad) valid fine rows
    a_nnz_starts: np.ndarray      # (ndev + 1,) A payload slab offsets
    a_pad: int                    # fine payload slab length (max nnz + 1)
    bs: int
    rpad: int                     # fine row slab pad
    n_fine: int


@dataclasses.dataclass
class DistCoarse:
    """Replicated coarsest-level solve data (the level is tiny).  Only
    staged when no AMG level is agglomerated."""

    part: RowPartition
    sel: np.ndarray               # (nnzb,) window ids into gathered payload
    rows: np.ndarray              # (nnzb,) global block coords
    cols: np.ndarray
    row_sel: np.ndarray           # (nbr,) window ids into gathered vectors
    nbr: int
    bs: int
    rpad: int
    ac_pad: int


@dataclasses.dataclass
class DistReplicatedLevel:
    """One agglomerated level: the level IS the single-device level
    (``ls`` carries the global plans ``level_state`` /
    ``ptap_numeric_data`` consume); every rank runs it redundantly."""

    ls: LevelSetup
    n_eqs: int                    # global equations (the placement metric)


@dataclasses.dataclass
class DistSwitch:
    """Gather-boundary staging where placement flips sharded->replicated.

    ``payload_sel``/``row_sel`` index one all-gather of the last sharded
    level's padded slabs to reassemble the global Galerkin payload
    (recompute) and the global fine residual (restriction).  The boundary
    restriction runs rank-redundantly after that gather, through the
    stored global ``r_ell`` when the setup carries one, else
    transpose-free off ``p_g`` and the ``p_t`` plan.  ``p_b`` is the
    boundary prolongator: sharded fine rows whose plan indices address the
    replicated coarse correction directly (``"replicated"`` halo).
    """

    payload_sel: np.ndarray       # (nnzb,) into gathered stage2 payload slabs
    row_sel: np.ndarray           # (nbr_fine,) into gathered residual slabs
    r_ell: Optional[BlockELL]     # stored global restriction, or None
    p_b: DistEll                  # slab rows <- replicated coarse vector
    nbr_c: int                    # replicated coarse vector block rows
    bs_c: int
    p_g: Optional[BlockELL] = None          # global prolongator payload
    p_t: Optional[EllTransposePlan] = None  # transpose-free P^T plan


@dataclasses.dataclass
class DistGAMG:
    """Cold distributed staging — valid while the setup's structures hold.

    ``precision`` is the setup's ``PrecisionPolicy``: constant payloads
    (P/R blocks, the cached P_oth operand) are staged at
    ``hierarchy_dtype``, the rank recompute and V-cycle run there, and the
    outer CG stays at ``krylov_dtype`` behind the boundary cast.

    Placement: ``levels`` holds the slab-sharded levels, ``repl`` the
    agglomerated tail, ``switch`` the gather boundary between them
    (``None`` when nothing is agglomerated; then ``coarse`` carries the
    replicated-Cholesky staging).  Level 0 always stays sharded.
    """

    ndev: int
    parts: List[RowPartition]     # per level, + the coarsest
    levels: List[DistLevel]       # the slab-sharded prefix
    coarse: Optional[DistCoarse]  # coarsest staging (no replicated tail)
    smoother: str
    degree: int
    precision: PrecisionPolicy = dataclasses.field(
        default_factory=PrecisionPolicy.double)
    repl: List[DistReplicatedLevel] = dataclasses.field(default_factory=list)
    switch: Optional[DistSwitch] = None
    coarse_struct: Optional[BlockCSR] = None   # coarsest structure (repl)
    coarse_eq_limit: int = 0
    #: the device set as a ``ProcessMesh``: the rank processes run its row
    #: axis (``mesh.pr == ndev`` slabs); a 2-D mesh's column axis splits
    #: each slab's halo traffic ``pc`` ways in ``dist_cycle_comm``
    mesh: Optional[ProcessMesh] = None

    @property
    def n_levels(self) -> int:
        """AMG levels (sharded + replicated), excluding the coarsest."""
        return len(self.levels) + len(self.repl)

    @property
    def placement(self) -> List[str]:
        """Per-level placement tags (+ the coarsest, always replicated)."""
        return (["sharded"] * len(self.levels)
                + ["replicated"] * len(self.repl) + ["replicated"])

    # ---- one rank's operands of the hot path ---------------------------
    def rank_args(self, r: int, device="cuda") -> dict:
        """Rank ``r``'s slice of every stacked plan, on ``device`` (the
        reference's ``sharded_args``, split): ELL indices int32 for the
        kernels, gathers int64, masks bool, constant payloads at the
        hierarchy dtype, each stage's segment offsets int32."""
        dev = backend.resolve_device(device)

        def t(a, dtype=None):
            if isinstance(a, torch.Tensor):
                return a[r].contiguous().to(dev)
            return torch.as_tensor(np.ascontiguousarray(a[r]),
                                   dtype=dtype).to(dev)

        def idx(a):
            return t(a, torch.int32)

        def split(pre: str, op: DistEll) -> dict:
            return {pre + "loc": idx(op.indices_local),
                    pre + "msk": t(op.int_mask, torch.bool)}

        lv_args = []
        for lv in self.levels:
            if lv.p_op is not None:
                transfers = dict(
                    p_idx=idx(lv.p_op.indices), p_data=t(lv.p_op.data),
                    r_idx=idx(lv.r_op.indices), r_data=t(lv.r_op.data),
                    **split("p_", lv.p_op), **split("r_", lv.r_op))
            else:   # switch boundary: the re-slicing prolongator's slabs
                transfers = dict(pb_idx=idx(self.switch.p_b.indices),
                                 pb_data=t(self.switch.p_b.data))
            s1, s2 = lv.stage1, lv.stage2
            lv_args.append(dict(
                transfers,
                a_idx=idx(lv.a_op.indices),
                a_gather=t(lv.a_op.gather, torch.int64),
                **split("a_", lv.a_op),
                s1_lhs=t(s1.lhs_gather, torch.int64),
                s1_rhs=t(s1.rhs_data),
                s1_off=torch.as_tensor(s1.seg_offsets(r)).to(dev),
                s2_lhs=t(s2.lhs_data),
                s2_rhs=t(s2.rhs_gather, torch.int64),
                s2_rhs_loc=t(s2.rhs_local, torch.int64),
                s2_msk=t(s2.local_mask, torch.bool),
                s2_off=torch.as_tensor(s2.seg_offsets(r)).to(dev),
                diag_sel=t(lv.diag_sel, torch.int64),
                diag_mask=t(lv.diag_mask, torch.bool),
                row_mask=t(lv.row_mask, torch.bool),
            ))
        return {"levels": lv_args}

    # ---- scatter/gather (the edges of the device-resident region) -------
    @property
    def payload_stage_dtype(self) -> torch.dtype:
        """Staging dtype of the fine payload slabs: wide enough for both
        the hierarchy chain and the mixed policy's krylov-dtype operator
        copy — the policy's, never the caller's."""
        return torch.promote_types(self.precision.hierarchy_dtype,
                                   self.precision.krylov_dtype)

    def _slabs(self, src: torch.Tensor, starts, pad: int, dtype,
               rank: Optional[int]) -> torch.Tensor:
        ranks = range(self.ndev) if rank is None else (rank,)
        out = torch.zeros((len(ranks), pad) + tuple(src.shape[1:]),
                          dtype=dtype, device=src.device)
        for i, r in enumerate(ranks):
            s, e = int(starts[r]), int(starts[r + 1])
            out[i, :e - s] = src[s:e]
        return out if rank is None else out[0]

    def scatter_fine_payloads(self, data, rank: Optional[int] = None
                              ) -> torch.Tensor:
        """Global ``(nnzb, bs, bs)`` fine values -> ``(ndev, a_pad, bs,
        bs)`` slabs (rank ``rank``'s ``(a_pad, bs, bs)`` slab when given)
        at ``payload_stage_dtype``, on the values' device."""
        lv = self.levels[0]
        return self._slabs(torch.as_tensor(data), lv.a_nnz_starts,
                           lv.a_pad, self.payload_stage_dtype, rank)

    def scatter_vector(self, b, rank: Optional[int] = None) -> torch.Tensor:
        """Global fine vector ``(n,)`` or panel ``(n, k)`` -> ``(ndev, rpad,
        bs[, k])`` padded slabs (rank ``rank``'s slab when given) at the
        policy's ``krylov_dtype``, on ``b``'s device."""
        lv, part = self.levels[0], self.parts[0]
        b = torch.as_tensor(b)
        b2 = b.reshape((part.nrows, lv.bs) + tuple(b.shape[1:]))
        return self._slabs(b2, part.starts, lv.rpad,
                           self.precision.krylov_dtype, rank)

    def gather_vector(self, x: torch.Tensor) -> torch.Tensor:
        """``(ndev, rpad, bs[, k])`` padded slabs -> global ``(n,)`` or
        ``(n, k)``."""
        part = self.parts[0]
        cat = torch.cat([x[r, :int(part.counts[r])]
                         for r in range(self.ndev)], dim=0)
        return cat.reshape((-1,) + tuple(x.shape[3:]))


@dataclasses.dataclass
class DistAssembly:
    """Per-rank device-assembly staging: the distributed rendering of the
    cached ``BlockCOOPlan``.

    ``plan.out_idx_sorted`` is monotone, so the contributions feeding rank
    ``r``'s fine payload slab (global output blocks
    ``a_nnz_starts[r]:a_nnz_starts[r+1]``) are one contiguous range of the
    globally sorted contribution stream: each rank sums a slice of the
    scatter-sum the single-device ``set_values_coo`` runs, in the same
    order, which is what makes the assembled slabs bitwise those of the
    global assembly.

    A contribution is (element, node pair); elements touching a slab
    boundary appear on both ranks, so each rank stages the ids of the
    elements it needs (``elem_ids``, padded) and recomputes their
    stiffness blocks itself.  The arrays are bitwise
    ``repro.dist.solver.DistAssembly``'s; ``rank_args`` adds the kernel's
    view of them (``perm`` into the rank's element blocks, the ``a_pad +
    1`` segment ``offsets``).
    """

    elem_ids: np.ndarray      # (ndev, epad) global element ids (pad -> 0)
    contrib_elem: np.ndarray  # (ndev, cpad) rank-local element index
    contrib_pa: np.ndarray    # (ndev, cpad) row node within the element
    contrib_pb: np.ndarray    # (ndev, cpad) column node within the element
    contrib_seg: np.ndarray   # (ndev, cpad) local slot in the payload slab
    contrib_mask: np.ndarray  # (ndev, cpad) valid contributions
    quad_b: np.ndarray        # shared quadrature arrays (host copies)
    quad_w: np.ndarray
    nn: int                   # nodes per element
    bs: int
    a_pad: int                # fine payload slab length (dg.levels[0])
    n_elements: int
    stage_dtype: torch.dtype  # dg.payload_stage_dtype (the policy's)
    #: rank operands staged so far, by (rank, device); the hot loop must
    #: stage each once (the reference's one compiled program)
    n_staged: int = dataclasses.field(default=0, compare=False)
    _staged: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def ndev(self) -> int:
        return self.elem_ids.shape[0]

    @property
    def epad(self) -> int:
        return self.elem_ids.shape[1]

    def _count(self, r: int) -> int:
        return int(self.contrib_mask[r].sum())

    def rank_args(self, r: int, device="cuda") -> dict:
        """Rank ``r``'s operands of the rank assembly on ``device``, staged
        once and cached: ``perm`` (int32, ``elem*nn*nn + pa*nn + pb`` of
        each valid contribution: its block in the rank's element-block
        stream), ``offsets`` (int32 ``(a_pad + 1,)``; slots past the
        rank's count are empty segments), the quadrature arrays at the
        stage dtype and ``elem_ids`` (int64, the gather of
        ``scatter_fields``)."""
        dev = backend.resolve_device(device)
        key = (r, str(dev))
        if key not in self._staged:
            k, nn = self._count(r), self.nn
            perm = (self.contrib_elem[r, :k].astype(np.int64) * nn * nn
                    + self.contrib_pa[r, :k] * nn + self.contrib_pb[r, :k])
            self._staged[key] = dict(
                perm=torch.as_tensor(perm.astype(np.int32)).to(dev),
                offsets=torch.as_tensor(_segment_offsets(
                    self.contrib_seg[r, :k], self.a_pad)).to(dev),
                quad_b=torch.as_tensor(self.quad_b).to(dev,
                                                       self.stage_dtype),
                quad_w=torch.as_tensor(self.quad_w).to(dev,
                                                       self.stage_dtype),
                elem_ids=torch.as_tensor(self.elem_ids[r]).to(dev))
            self.n_staged += 1
        return self._staged[key]

    def scatter_fields(self, E, nu, rank: Optional[int] = None,
                       device=None):
        """Global per-element fields (or scalars) -> ``(ndev, epad)`` slabs
        (rank ``rank``'s ``(epad,)`` slab when given), at ``stage_dtype``
        whatever the caller's dtype, as the reference stages them.

        Host arrays and CPU tensors are cast and gathered on the host and
        land on ``device`` (default: where they are): the two slabs are
        the only bytes a coefficient update moves.  For one rank, a tensor
        already on ``device`` (a card) is gathered there through the
        rank's staged ``elem_ids``, so a field made on the card copies
        nothing.
        """
        return (self._scatter(E, rank, device),
                self._scatter(nu, rank, device))

    def _scatter(self, v, rank: Optional[int], device) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            dev = v.device if device is None else \
                backend.resolve_device(device)
            if v.device == dev and dev.type != "cpu" and rank is not None:
                v = v.to(self.stage_dtype).expand(self.n_elements)
                return v[self.rank_args(rank, dev)["elem_ids"]]
            v = v.detach().cpu().numpy()
        else:
            dev = torch.device("cpu") if device is None else \
                backend.resolve_device(device)
        ids = self.elem_ids if rank is None else self.elem_ids[rank]
        dt = torch.empty((), dtype=self.stage_dtype).numpy().dtype
        flat = np.broadcast_to(np.asarray(v, dt), (self.n_elements,))
        return torch.as_tensor(np.ascontiguousarray(flat[ids])).to(dev)


def build_dist_assembly(dg: DistGAMG, assembler) -> DistAssembly:
    """Cold staging of device FEM assembly over the fine payload slabs.

    ``assembler`` is the problem's ``fem.device_stiffness
    .DeviceAssembler``; its ``BlockCOOPlan`` must be the one the fine
    operator of ``dg``'s setup was assembled with (raises otherwise).  Its
    quadrature arrays are copied to the host once, here.
    """
    plan = assembler.plan
    lv0 = dg.levels[0]
    nn = assembler.nn
    if int(lv0.a_nnz_starts[-1]) != plan.nnzb:
        raise ValueError(
            f"assembler plan does not match the staged fine operator: "
            f"plan has {plan.nnzb} output blocks, the fine level has "
            f"{int(lv0.a_nnz_starts[-1])}")
    sorted_input = plan.keep[plan.order]          # declared-coordinate ids
    elem = sorted_input // (nn * nn)
    pair = sorted_input % (nn * nn)
    seg = plan.out_idx_sorted                     # monotone output blocks
    starts = lv0.a_nnz_starts
    los = np.searchsorted(seg, starts[:-1], side="left")
    his = np.searchsorted(seg, starts[1:], side="left")
    per_uniq, per_loc = [], []
    for r in range(dg.ndev):
        uniq, local = np.unique(elem[los[r]:his[r]], return_inverse=True)
        per_uniq.append(uniq)
        per_loc.append(local)
    epad = max(1, max(len(u) for u in per_uniq))
    cpad = max(1, int((his - los).max()))
    ndev = dg.ndev
    elem_ids = np.zeros((ndev, epad), dtype=np.int64)
    c_elem = np.zeros((ndev, cpad), dtype=np.int32)
    c_pa = np.zeros((ndev, cpad), dtype=np.int32)
    c_pb = np.zeros((ndev, cpad), dtype=np.int32)
    # padded contributions name the (always unused) last slab slot, as the
    # reference's do; the kernel's offsets never reach them
    c_seg = np.full((ndev, cpad), lv0.a_pad - 1, dtype=np.int32)
    c_mask = np.zeros((ndev, cpad), dtype=bool)
    for r in range(ndev):
        lo, hi = los[r], his[r]
        k = hi - lo
        elem_ids[r, :len(per_uniq[r])] = per_uniq[r]
        c_elem[r, :k] = per_loc[r]
        c_pa[r, :k] = pair[lo:hi] // nn
        c_pb[r, :k] = pair[lo:hi] % nn
        c_seg[r, :k] = seg[lo:hi] - starts[r]
        c_mask[r, :k] = True
    return DistAssembly(elem_ids=elem_ids, contrib_elem=c_elem,
                        contrib_pa=c_pa, contrib_pb=c_pb, contrib_seg=c_seg,
                        contrib_mask=c_mask,
                        quad_b=assembler.quad_b.detach().cpu().numpy(),
                        quad_w=assembler.quad_w.detach().cpu().numpy(),
                        nn=nn, bs=plan.br, a_pad=lv0.a_pad,
                        n_elements=assembler.n_elements,
                        stage_dtype=dg.payload_stage_dtype)


def _placement_split(setupd: GAMGSetup, ndev: int, limit: int) -> int:
    """First level index that leaves the fully-sharded path: a level is
    agglomerated when its global equation count per rank is at or below
    ``limit``.  Level 0 never qualifies, and level sizes shrink, so the
    split is one index."""
    n = len(setupd.levels)
    if limit <= 0:
        return n
    for li in range(1, n):
        ls = setupd.levels[li]
        if ls.n_fine * ls.A0.br <= limit * ndev:
            return li
    return n


def _host(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A payload as a CPU tensor at ``dtype`` (staging input)."""
    return t.detach().to("cpu").to(dtype)


def build_dist_gamg(setupd: GAMGSetup, ndev, *,
                    coarse_eq_limit: Optional[int] = None) -> DistGAMG:
    """Cold distributed staging of a single-device GAMG setup.

    ``ndev`` is an int rank count or a ``ProcessMesh`` (the slabs follow
    its row axis; a 2-D mesh's column axis is recorded for the comm
    model).  Constant payloads are staged at the policy's
    ``hierarchy_dtype``.  ``coarse_eq_limit`` is the placement threshold
    in equations per rank: ``None`` defers to ``setupd.coarse_eq_limit``
    and then to ``DEFAULT_COARSE_EQ_LIMIT``; ``0`` keeps every level
    slab-sharded.  Plans are numpy, bitwise ``repro.dist.build_dist_gamg``'s
    on the same setup.
    """
    if not setupd.levels:
        raise ValueError("distributed path needs at least one AMG level")
    mesh = as_mesh(ndev)
    mesh.row_partition(setupd.levels[0].A0.nbr)   # validate rows >= pr
    ndev = mesh.pr
    if coarse_eq_limit is None:
        coarse_eq_limit = setupd.coarse_eq_limit
    if coarse_eq_limit is None:
        coarse_eq_limit = DEFAULT_COARSE_EQ_LIMIT
    # the eq-per-rank rule counts every device of the mesh (pr * pc)
    n_sharded = _placement_split(setupd, mesh.ndev, coarse_eq_limit)
    h = setupd.precision.hierarchy_dtype
    parts = [partition_rows(ls.n_fine, ndev) for ls in setupd.levels]
    parts.append(partition_rows(setupd.coarse_struct.nbr, ndev))
    levels: List[DistLevel] = []
    for li, ls in enumerate(setupd.levels[:n_sharded]):
        fine, coarse = parts[li], parts[li + 1]
        boundary = li == n_sharded - 1 and n_sharded < len(setupd.levels)
        A0 = ls.A0
        a_nnz_starts = A0.indptr[fine.starts]
        a_pad = int(np.diff(a_nnz_starts).max()) + 1
        p_h = _host(ls.P.data, h)
        cache = ls.ptap_cache
        s1 = build_stage1(cache.ap_plan, fine, A0.indptr, p_h)
        s2 = build_stage2(cache.ac_plan, coarse, fine, cache.ap_plan.indptr,
                          s1.out_pad, p_h, cache.r_perm)
        diag_sel, diag_mask = build_diag_sel(A0.indptr, A0.indices, fine,
                                             a_pad)
        rpad = max(fine.max_count, 1)
        row_mask = np.arange(rpad)[None, :] < fine.counts[:, None]
        # the sharded restriction slices a stored-form operand; a
        # transpose-free setup computes it here, cold, at staging
        R_sh = None if boundary else restriction_bcsr(ls)
        levels.append(DistLevel(
            a_op=build_dist_ell(A0, fine, fine, payload_pad=a_pad),
            p_op=None if boundary else
                build_dist_ell(ls.P, fine, coarse, const_data=p_h),
            r_op=None if boundary else
                build_dist_ell(R_sh, coarse, fine,
                               const_data=_host(R_sh.data, h)),
            stage1=s1, stage2=s2, diag_sel=diag_sel, diag_mask=diag_mask,
            row_mask=row_mask, a_nnz_starts=a_nnz_starts, a_pad=a_pad,
            bs=A0.br, rpad=rpad, n_fine=ls.n_fine))
    repl = [DistReplicatedLevel(ls=ls, n_eqs=ls.n_fine * ls.A0.br)
            for ls in setupd.levels[n_sharded:]]
    switch = None
    coarse_staging = None
    if repl:
        bls = setupd.levels[n_sharded - 1]       # last sharded level
        first = repl[0].ls                       # first replicated level
        fine = parts[n_sharded - 1]
        stored = bls.r_ell is not None
        switch = DistSwitch(
            payload_sel=build_payload_gather(
                first.A0.indptr, parts[n_sharded],
                levels[-1].stage2.out_pad),
            row_sel=build_row_gather(fine, max(fine.max_count, 1)),
            r_ell=_at(bls.r_ell, h) if stored else None,
            p_g=None if stored else _at(bls.p_ell, h),
            p_t=None if stored else bls.pt,
            p_b=build_dist_ell(bls.P, fine, parts[n_sharded],
                               const_data=_host(bls.P.data, h),
                               replicated_cols=True),
            nbr_c=first.A0.nbr, bs_c=first.A0.br)
    else:
        Ac = setupd.coarse_struct
        c_part = parts[-1]
        ac_pad = levels[-1].stage2.out_pad
        c_rpad = max(c_part.max_count, 1)
        coarse_staging = DistCoarse(
            part=c_part,
            sel=build_payload_gather(Ac.indptr, c_part, ac_pad),
            rows=np.repeat(np.arange(Ac.nbr), np.diff(Ac.indptr)),
            cols=np.asarray(Ac.indices, dtype=np.int64),
            row_sel=build_row_gather(c_part, c_rpad),
            nbr=Ac.nbr, bs=Ac.br, rpad=c_rpad, ac_pad=ac_pad)
    return DistGAMG(ndev=ndev, parts=parts, levels=levels,
                    coarse=coarse_staging, smoother=setupd.smoother,
                    degree=setupd.degree, precision=setupd.precision,
                    repl=repl, switch=switch,
                    coarse_struct=setupd.coarse_struct if repl else None,
                    coarse_eq_limit=int(coarse_eq_limit), mesh=mesh)


# ---------------------------------------------------------------------------
# Hot path (per-rank functions)
# ---------------------------------------------------------------------------

def _pdot(comm, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return comm.allreduce_sum(torch.dot(a.reshape(-1), b.reshape(-1)))


def _pnorm(comm, a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(comm.allreduce_sum(torch.sum(a * a)))


def _pdot_cols(comm, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column global dot over ``(rpad, bs, k)`` slabs -> ``(k,)``."""
    return comm.allreduce_sum(torch.sum(a * b, dim=(0, 1)))


def _pnorm_cols(comm, a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(comm.allreduce_sum(torch.sum(a * a, dim=(0, 1))))


def _rank_spmv(op: DistEll, a: dict, pre: str, data: torch.Tensor,
               x: torch.Tensor, comm, overlap: bool, accum=None
               ) -> torch.Tensor:
    """Per-rank SpMV through one of the two exchange renderings.

    ``a`` is the level's rank args, ``pre`` the operator's key prefix
    (``"a_"``/``"p_"``/``"r_"``/``"pb_"``).  Blocking: assemble the whole
    window, one apply over all rows.  Overlapped: start the exchange,
    apply the full slab against the rank's own vector while it is in
    flight, finish the window, apply again off the window, select per row.
    Halos that move no bytes take the blocking rendering.
    """
    idx = a[pre + "idx"]
    if not overlap or op.halo.strategy in ("local", "replicated"):
        return dist_ell_apply(idx, data, halo_window(x, op.halo, comm),
                              accum_dtype=accum)
    pend = start_halo_exchange(x, op.halo, comm)
    y_int = dist_ell_apply_interior(a[pre + "loc"], data, x,
                                    accum_dtype=accum)
    win = finish_halo_exchange(pend)
    y_bnd = dist_ell_apply_boundary(idx, data, win, accum_dtype=accum)
    return combine_split(a[pre + "msk"], y_int, y_bnd)


def _rank_lambda_max(lv: DistLevel, a: dict, dinva_data: torch.Tensor,
                     row_mask: torch.Tensor, comm, overlap: bool,
                     iters: int = 10, accum=None) -> torch.Tensor:
    """Distributed power iteration — mirrors ``lambda_max_dinv_a``."""

    def spmv(x):
        return _rank_spmv(lv.a_op, a, "a_", dinva_data, x, comm, overlap,
                          accum=accum)

    x0 = row_mask[:, None] * torch.ones((lv.rpad, lv.bs),
                                        dtype=dinva_data.dtype,
                                        device=dinva_data.device)
    x = x0 / _pnorm(comm, x0)
    tiny = torch.finfo(dinva_data.dtype).tiny
    for _ in range(iters):
        y = spmv(x)
        x = y / torch.clamp_min(_pnorm(comm, y), tiny)
    return _pnorm(comm, spmv(x))


def _rank_recompute(dg: DistGAMG, args: dict, a_slab: torch.Tensor, comm,
                    overlap: bool, lambda_iters: int = 10):
    """Distributed hot hierarchy rebuild: chained PtAP + smoother data.

    The payload chain runs at the policy's hierarchy dtype (the incoming
    fine slab is cast once at the top); a mixed policy also keeps level
    0's krylov-dtype payload gather (``a_data_kr``) for the outer CG.
    With a replicated tail the sharded chain stops at the switch: one
    all-gather of the last stage-2 payload slabs, the gather-boundary plan
    reassembles the first replicated operator's global payload, and the
    tail is the single-device chain run on every rank.
    ``lambda_iters`` is each level's power-iteration count (the message
    count uses 1: the reference's traced loop holds its body once).
    """
    policy = dg.precision
    h = policy.hierarchy_dtype
    acc = policy.kernel_accum_dtype
    acc_p = torch.promote_types(h, policy.accum_dtype)
    states = []
    a_cur = a_slab.to(h)
    for li, lv in enumerate(dg.levels):
        a = args["levels"][li]
        a_ell_data = a_cur[a["a_gather"]]
        eye = torch.eye(lv.bs, dtype=h, device=a_cur.device)
        diag = torch.where(a["diag_mask"][:, None, None],
                           a_cur[a["diag_sel"]], eye)
        dinv = invert_diag_blocks(diag.to(policy.factor_dtype)).to(h)
        dinva = torch.einsum("rab,rkbc->rkac", dinv.to(acc_p),
                             a_ell_data.to(acc_p)).to(h).contiguous()
        lam = _rank_lambda_max(lv, a, dinva, a["row_mask"], comm, overlap,
                               iters=lambda_iters, accum=acc)
        st = dict(a_data=a_ell_data, dinv=dinv, lam=lam)
        if li == 0 and policy.mixed:
            st["a_data_kr"] = a_slab.to(policy.krylov_dtype)[a["a_gather"]]
        states.append(st)
        # next-level payload: local A@P (cached P_oth), then the
        # off-process reduction window for R@(AP)
        ap = dist_stage_apply(a_cur[a["s1_lhs"]], a["s1_rhs"], a["s1_off"],
                              accum_dtype=acc)
        s2 = lv.stage2
        if overlap and s2.halo.strategy not in ("local", "replicated"):
            a_cur = dist_stage_apply_overlap(
                a["s2_lhs"], ap, s2.halo, a["s2_rhs"], a["s2_rhs_loc"],
                a["s2_msk"], a["s2_off"], comm, accum_dtype=acc)
        else:
            ap_win = halo_window(ap, s2.halo, comm)
            a_cur = dist_stage_apply(a["s2_lhs"], ap_win[a["s2_rhs"]],
                                     a["s2_off"], accum_dtype=acc)
    if dg.repl:
        g = comm.all_gather_tiled(a_cur)
        a_data = g[device_array(dg.switch, "payload_sel", g.device)]
        for rl in dg.repl:
            states.append(level_state(rl.ls, a_data, policy))
            a_data = ptap_numeric_data(rl.ls.ptap_cache, a_data,
                                       rl.ls.P.data.to(h), accum_dtype=acc)
        chol = coarse_cholesky(dg.coarse_struct.with_data(a_data).to_dense(),
                               policy)
    else:
        chol = _rank_coarse_chol(dg, a_cur, comm)
    return states, chol


def _rank_coarse_chol(dg: DistGAMG, ac_slab: torch.Tensor, comm
                      ) -> torch.Tensor:
    """Replicated dense Cholesky of the (tiny) coarsest operator, with the
    single-device path's jitter-escalation retry (``jittered_cholesky``);
    every rank factors the same gathered blocks."""
    c = dg.coarse
    policy = dg.precision
    dev = ac_slab.device
    g = comm.all_gather_tiled(ac_slab)
    blocks = g[device_array(c, "sel", dev)]
    dense4 = torch.zeros((c.nbr, c.nbr, c.bs, c.bs), dtype=ac_slab.dtype,
                         device=dev)
    dense4[device_array(c, "rows", dev), device_array(c, "cols", dev)] = \
        blocks
    n = c.nbr * c.bs
    dense = dense4.permute(0, 2, 1, 3).reshape(n, n)
    chol = jittered_cholesky(dense.to(policy.factor_dtype),
                             policy.coarse_jitter_scale(),
                             policy.coarse_retry_scale())
    return chol.to(policy.hierarchy_dtype)


def _rank_coarse_solve(dg: DistGAMG, chol: torch.Tensor, rhs: torch.Tensor,
                       comm) -> torch.Tensor:
    """Replicated coarse solve; every rank slices its own slab back out.
    ``rhs`` is the ``(rpad, bs)`` coarse slab or its ``(rpad, bs, k)``
    panel."""
    c = dg.coarse
    trailing = tuple(rhs.shape[2:])
    g = comm.all_gather_tiled(rhs)                     # (ndev*rpad, bs..)
    rhs_g = g[device_array(c, "row_sel", rhs.device)]  # (nbr, bs[, k])
    xc = coarse_solve(chol, rhs_g.reshape((c.nbr * c.bs,) + trailing))
    xcb = xc.reshape((c.nbr, c.bs) + trailing)
    start, cnt = int(c.part.starts[comm.rank]), int(c.part.counts[comm.rank])
    mine = torch.zeros((c.rpad, c.bs) + trailing, dtype=rhs.dtype,
                       device=rhs.device)
    mine[:cnt] = xcb[start:start + cnt]
    return mine


def _rank_assemble(da: DistAssembly, aargs: dict, E: torch.Tensor,
                   nu: torch.Tensor) -> torch.Tensor:
    """Rank-local device assembly: coefficient slabs -> the ``(a_pad, bs,
    bs)`` fine payload slab.

    The batched quadrature over the rank's padded element set (padded
    elements compute element 0's block and no contribution reads it), then
    the rank's contiguous slice of the global sorted scatter-sum as one
    ``block_seg_sum`` launch that reads the element blocks through
    ``perm``: every segment sums its contributions in the global plan's
    order, so the slab is bitwise ``scatter_fine_payloads`` of the
    globally assembled payload when the element blocks are.  ``aargs``
    from ``da.rank_args(rank, device)``.
    """
    vals = element_value_stream(aargs["quad_b"].to(E.dtype),
                                aargs["quad_w"].to(E.dtype), E, nu, da.nn)
    return seg_ops.block_seg_sum(vals, aargs["offsets"], aargs["perm"])


def _rank_smooth(dg: DistGAMG, spmv, st: dict, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The single-device V-cycle's unfused recurrences
    (``core.vcycle.chebyshev_recurrence`` / ``pbjacobi_recurrence``) with
    per-rank spmv and pbjacobi closures."""
    dinv = st["dinv"]
    acc = torch.promote_types(dinv.dtype, dg.precision.accum_dtype)

    def pbj(r):
        return torch.einsum("nab,nb...->na...", dinv.to(acc),
                            r.to(acc)).to(r.dtype).contiguous()

    if dg.smoother == "chebyshev":
        return chebyshev_recurrence(spmv, pbj, st["lam"], b, x, dg.degree)
    return pbjacobi_recurrence(spmv, pbj, b, x, dg.degree)


def _repl_smooth(dg: DistGAMG, st: LevelState, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Smoother on a replicated level: the single-device one."""
    return apply_smoother(st, b, x, dg.smoother, dg.degree)


def _boundary_restrict(dg: DistGAMG, r: torch.Tensor, comm) -> torch.Tensor:
    """Cross sharded->replicated: one all-gather of the fine residual
    slabs, reassemble the global vector, restrict it on every rank."""
    sw = dg.switch
    g = comm.all_gather_tiled(r)                      # (ndev*rpad, bs[, k])
    rg = g[device_array(sw, "row_sel", r.device)]     # (nbr_f, bs[, k])
    flat = rg.reshape((rg.shape[0] * rg.shape[1],) + tuple(rg.shape[2:]))
    if sw.r_ell is not None:
        return apply_ell(sw.r_ell, flat)
    return apply_ell_t(sw.p_g, sw.p_t, flat)


def _boundary_prolong(dg: DistGAMG, a: dict, xc: torch.Tensor, comm,
                      overlap: bool, accum=None) -> torch.Tensor:
    """Cross replicated->sharded: the boundary prolongator's indices
    address the replicated correction directly (``"replicated"`` halo),
    so re-slicing it into row slabs moves nothing."""
    sw = dg.switch
    xcb = xc.reshape((sw.nbr_c, sw.bs_c) + tuple(xc.shape[1:]))
    return _rank_spmv(sw.p_b, a, "pb_", a["pb_data"], xcb, comm, overlap,
                      accum=accum)


def _rank_vcycle(dg: DistGAMG, args: dict, states: list,
                 chol: torch.Tensor, b: torch.Tensor, comm,
                 overlap: bool) -> torch.Tensor:
    """One V-cycle over the placed hierarchy (zero initial guess).

    Sharded levels run the slab recurrences with halo-window SpMVs;
    replicated levels run the single-device functions on global vectors,
    on every rank, with no communication; restriction crosses the switch
    with one all-gather, prolongation re-slices for free.  Every sharded
    apply threads the policy's kernel accumulator.
    """
    acc = dg.precision.kernel_accum_dtype
    ns = len(dg.levels)
    bs_stack, x_stack = [], []
    rhs = b
    for li, lv in enumerate(dg.levels):
        a = args["levels"][li]
        st = states[li]

        def spmv_a(v, a=a, st=st, lv=lv):
            return _rank_spmv(lv.a_op, a, "a_", st["a_data"], v, comm,
                              overlap, accum=acc)

        x = _rank_smooth(dg, spmv_a, st, rhs, torch.zeros_like(rhs))
        r = rhs - spmv_a(x)
        bs_stack.append(rhs)
        x_stack.append(x)
        if li == ns - 1 and dg.repl:
            rhs = _boundary_restrict(dg, r, comm)
        else:
            rhs = _rank_spmv(lv.r_op, a, "r_", a["r_data"], r, comm,
                             overlap, accum=acc)
    if dg.repl:
        for li in range(ns, ns + len(dg.repl)):
            st = states[li]
            x = _repl_smooth(dg, st, rhs, torch.zeros_like(rhs))
            r = rhs - apply_ell(st.a_ell, x)
            bs_stack.append(rhs)
            x_stack.append(x)
            rhs = apply_restriction(st, r)
        xc = coarse_solve(chol, rhs)
        for li in reversed(range(ns, ns + len(dg.repl))):
            st = states[li]
            x = x_stack[li] + apply_ell(st.p_ell, xc)
            xc = _repl_smooth(dg, st, bs_stack[li], x)
    else:
        xc = _rank_coarse_solve(dg, chol, rhs, comm)
    for li in reversed(range(ns)):
        a = args["levels"][li]
        st = states[li]
        lv = dg.levels[li]

        def spmv_a(v, a=a, st=st, lv=lv):
            return _rank_spmv(lv.a_op, a, "a_", st["a_data"], v, comm,
                              overlap, accum=acc)

        if li == ns - 1 and dg.repl:
            corr = _boundary_prolong(dg, a, xc, comm, overlap, accum=acc)
        else:
            corr = _rank_spmv(lv.p_op, a, "p_", a["p_data"], xc, comm,
                              overlap, accum=acc)
        x = x_stack[li] + corr
        xc = _rank_smooth(dg, spmv_a, st, bs_stack[li], x)
    return xc


def _fine_apply(dg: DistGAMG, args: dict, states: list, comm,
                overlap: bool):
    """The outer CG's operator: level 0's krylov-dtype payload under a
    mixed policy, else its hierarchy payload."""
    a0 = args["levels"][0]
    data = states[0].get("a_data_kr", states[0]["a_data"])
    return lambda v: _rank_spmv(dg.levels[0].a_op, a0, "a_", data, v, comm,
                                overlap)


def _rank_pcg(dg: DistGAMG, args: dict, states: list, chol: torch.Tensor,
              b: torch.Tensor, comm, rtol: float, maxiter: int,
              overlap: bool = False, stall_window: int = 40,
              x0: torch.Tensor | None = None):
    """Distributed PCG: ``core.krylov.pcg`` itself (its health flags, best
    iterate and fault sites) with rank-reduced dots and norms.  Every
    flag and the exit test read the reduced scalars, which are the same
    bits on every rank, so the exit is collective with no extra message;
    a fault on one rank reaches every rank's flags through the reduction
    within one iteration.  Returns ``(x, iters, relres, converged,
    status)``."""
    res = pcg(_fine_apply(dg, args, states, comm, overlap),
              lambda r: _rank_vcycle(dg, args, states, chol, r, comm,
                                     overlap),
              b, x0=x0, rtol=rtol, maxiter=maxiter,
              precond_dtype=dg.precision.smoother_dtype,
              stall_window=stall_window,
              dot=lambda u, v: _pdot(comm, u, v),
              norm=lambda u: _pnorm(comm, u))
    return res.x, res.iters, res.relres, res.converged, res.health.status


def _rank_block_pcg(dg: DistGAMG, args: dict, states: list,
                    chol: torch.Tensor, b: torch.Tensor, comm, rtol: float,
                    maxiter: int, overlap: bool = False,
                    stall_window: int = 40,
                    x0: torch.Tensor | None = None):
    """Distributed masked panel PCG over ``(rpad, bs, k)`` slabs:
    ``multirhs.block_krylov.block_pcg`` with rank-reduced per-column
    reductions (``block_spmm`` on every slab apply).  ``iters``,
    ``relres``, ``converged`` and ``status`` are per column."""
    res = block_pcg(_fine_apply(dg, args, states, comm, overlap),
                    lambda r: _rank_vcycle(dg, args, states, chol, r, comm,
                                           overlap),
                    b, x0=x0, rtol=rtol, maxiter=maxiter,
                    col_dot=lambda u, v: _pdot_cols(comm, u, v),
                    col_norm=lambda u: _pnorm_cols(comm, u),
                    precond_dtype=dg.precision.smoother_dtype,
                    stall_window=stall_window)
    return res.x, res.iters, res.relres, res.converged, res.health.status


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

def make_dist_solver(dg: DistGAMG, setupd: GAMGSetup, comm, *,
                     rtol: float = 1e-8, maxiter: int = 200,
                     warm_start: bool = False):
    """One rank's hot path: ``(args, a0, b) -> (x, iters, relres, ok,
    status)``, every rank of ``comm`` calling it with its own operands.

    ``args`` from ``dg.rank_args(comm.rank)``, ``a0`` the rank's fine
    payload slab (``dg.scatter_fine_payloads(values, comm.rank)``: new
    operator values, the Newton step), ``b`` its right-hand side slab
    (``dg.scatter_vector(b, comm.rank)``), a ``(rpad, bs)`` vector slab or
    a ``(rpad, bs, k)`` panel (then the masked panel CG runs and
    ``iters``, ``relres``, ``ok`` and ``status`` are per column).  One
    call recomputes the hierarchy, then CG-solves; ``x`` is the rank's
    solution slab, the rest is the same on every rank.  ``status`` is the
    int32 health code of ``repro_torch.robust.health``.

    ``warm_start=True`` adds a trailing ``x0`` slab, ``(args, a0, b,
    x0)``: each rank's CG starts from the prior iterate.  The overlap knob
    and the fault schedule in force at the first call with each argument
    signature hold for every later call (``robust.inject.traced``), as
    the reference's trace binds them; with spans on at build time each
    call lands one rank-0 wall observation in ``dist/solve/seconds``.
    """
    del setupd  # the structure is staged in dg; kept for call-site symmetry

    if warm_start:
        def rank_fn(args, a0, b, x0, *, overlap):
            return _rank_solve(dg, args, a0, b, x0, comm, rtol, maxiter,
                               overlap)
    else:
        def rank_fn(args, a0, b, *, overlap):
            return _rank_solve(dg, args, a0, b, None, comm, rtol, maxiter,
                               overlap)

    return _with_rank0_span(inject.traced(rank_fn, _knobs), "dist/solve")


def make_dist_coeff_solver(dg: DistGAMG, da: DistAssembly, comm, *,
                           rtol: float = 1e-8, maxiter: int = 200,
                           warm_start: bool = False):
    """One rank's coefficient hot path: ``(args, aargs, E, nu, b) -> (x,
    iters, relres, ok, status)``.

    The quasi-static front door: instead of a pre-assembled value stream
    (``make_dist_solver``'s ``a0``), each rank receives its coefficient
    slabs (``da.scatter_fields(E, nu, comm.rank, device)``) and runs the
    rank assembly (``_rank_assemble``: one ``block_seg_sum`` launch), the
    recompute and the CG solve — the distributed twin of
    ``gamg.make_coeff_solve``.  ``aargs`` from ``da.rank_args(comm.rank,
    device)``; everything else as ``make_dist_solver`` (a ``(rpad, bs,
    k)`` panel ``b`` runs the masked panel CG).

    ``warm_start=True`` appends an ``x0`` slab, ``(args, aargs, E, nu, b,
    x0)``, so a time march feeds each rank's previous x slab straight back
    in: no gather or scatter between steps.  The overlap knob and the
    fault schedule bind at the first call with each argument signature,
    and spans at build time time the call in ``dist/coeff_solve``, as on
    ``make_dist_solver``.
    """

    def rank_body(args, aargs, E, nu, b, x0, overlap):
        with obs_trace.span("dist/assemble"):
            a_slab = _rank_assemble(da, aargs, E, nu)
        return _rank_solve(dg, args, a_slab, b, x0, comm, rtol, maxiter,
                           overlap)

    if warm_start:
        def rank_fn(args, aargs, E, nu, b, x0, *, overlap):
            return rank_body(args, aargs, E, nu, b, x0, overlap)
    else:
        def rank_fn(args, aargs, E, nu, b, *, overlap):
            return rank_body(args, aargs, E, nu, b, None, overlap)

    return _with_rank0_span(inject.traced(rank_fn, _knobs),
                            "dist/coeff_solve")


def _knobs() -> dict:
    return dict(overlap=backend.resolve_overlap() == "on")


def _rank_solve(dg: DistGAMG, args: dict, a_slab: torch.Tensor,
                b: torch.Tensor, x0, comm, rtol: float, maxiter: int,
                overlap: bool):
    """The recompute, then the vector or panel CG, under their spans."""
    with obs_trace.span("dist/recompute"):
        states, chol = _rank_recompute(dg, args, a_slab, comm, overlap)
    run_pcg = _rank_block_pcg if b.ndim == 3 else _rank_pcg
    with obs_trace.span("dist/pcg"):
        return run_pcg(dg, args, states, chol, b, comm, rtol, maxiter,
                       overlap, x0=x0)


def _with_rank0_span(fn, name: str):
    """``fn`` in a rank-0 host timing span (``obs.trace.rank0_span``) when
    spans are on at build time; ``fn`` itself otherwise."""
    if not obs_trace.spans_enabled():
        return fn

    def timed(*args):
        with obs_trace.rank0_span(name) as stop:
            return stop(fn(*args))

    return timed
