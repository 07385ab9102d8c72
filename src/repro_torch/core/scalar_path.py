"""Scalar (AIJ) solve path — the paper's baseline, kept out of the blocked
coarsening path (torch twin of ``repro.core.scalar_path``).

Builds a scalar-format hierarchy from the *same* GAMG setup: identical
aggregates, prolongator values, smoother data and Chebyshev bounds, with
the level operators and transfer operators expanded to 1x1-block CSR.
Because it is the same algorithm in a different storage format, CG
converges in the same iteration count to the same true residual (paper
Sec. 4.1).  ``gamg.hier_solve`` takes the scalar hierarchy as it is: its
``A x``, ``P x`` and ``R r`` run through ``block_spmv`` at 1x1 and its
smoothing steps through the scalar-row ``fused_smoother`` entry (1x1 rows,
``D^-1`` in node blocks).

On the device the expansion is a gather: each level's scalar structures
and expand maps are built once per setup on the host (``_structures``,
cached on the setup), its ELL plans once from those (``scalar_levels``)
and their index arrays copied to the device once, so a
``recompute_scalar`` copies nothing from the host.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR, BlockELL, ELLPlan
from repro_torch.core.gamg import GAMGSetup, _at, _coarse_dense, \
    coarse_cholesky, level_state, restriction_bcsr
from repro_torch.core.ptap import ptap_numeric_data, ptap_symbolic
from repro_torch.core.scalar_csr import expand_bcsr, expand_structure
from repro_torch.core.vcycle import Hierarchy, LevelState


def expand_map(A: BlockCSR) -> np.ndarray:
    """Flat gather map: scalar CSR data = ``A.data.reshape(-1)[map]``
    (int64), so the scalar numeric path runs as a device gather of the
    blocked payloads (no host conversion on the timed path)."""
    return expand_structure(A)[2]


def scalar_ell_plan(A: BlockCSR, structure=None) -> ELLPlan:
    """The ELL plan of ``expand_bcsr(A)`` with its gather composed with
    the expand map: ``plan.build(a_data.reshape(-1, 1, 1))`` is
    ``expand_bcsr(A.with_data(a_data)).to_ell()``, one device gather from
    the blocked payload (``structure``: ``expand_structure(A)`` where the
    caller holds it)."""
    s_indptr, s_indices, emap = expand_structure(A) if structure is None \
        else structure
    meta = torch.empty((len(s_indices), 1, 1), dtype=A.data.dtype,
                       device="meta")
    plan = BlockCSR(s_indptr, s_indices, meta, A.nbc * A.bc).ell_plan()
    return dataclasses.replace(plan, gather=emap[plan.gather])


@dataclasses.dataclass
class ScalarLevel:
    """One level's cached scalar forms (cold, once per setup)."""

    a_plan: ELLPlan      # blocked payload -> scalar ELL of the operator
    p_ell: BlockELL      # expanded prolongator (fixed values)
    r_ell: BlockELL      # expanded stored restriction (fixed values)


def _structures(setupd: GAMGSetup) -> list:
    """Each level's ``(expand_structure(A0), expand_structure(P))``, on
    the host at the first call and cached on the setup: the scalar levels
    and the scalar PtAP chain expand each operator from these, once per
    setup."""
    cached = setupd.__dict__.get("_scalar_structures")
    if cached is None:
        cached = [(expand_structure(ls.A0), expand_structure(ls.P))
                  for ls in setupd.levels]
        setupd.__dict__["_scalar_structures"] = cached
    return cached


def scalar_levels(setupd: GAMGSetup) -> List[ScalarLevel]:
    """Each level's scalar ELL plan and expanded transfer operators, built
    at the first call and cached on the setup.  The scalar baseline keeps
    an expanded stored restriction whatever the setup's restriction mode
    (scalar CSR cannot apply P's blocks transposed on register)."""
    cached = setupd.__dict__.get("_scalar_levels")
    if cached is None:
        cached = [ScalarLevel(a_plan=scalar_ell_plan(ls.A0, a_st),
                              p_ell=expand_bcsr(ls.P, p_st).to_ell(),
                              r_ell=expand_bcsr(
                                  restriction_bcsr(ls)).to_ell())
                  for ls, (a_st, p_st) in zip(setupd.levels,
                                              _structures(setupd))]
        setupd.__dict__["_scalar_levels"] = cached
    return cached


def build_scalar_ptap_chain(setupd: GAMGSetup):
    """Scalar-format hot PtAP chain with cached symbolic plans.

    Mirrors the blocked ``gamg.recompute`` PtAP chain in expanded AIJ
    storage: the cold phase (here) expands every level operator and
    prolongator and builds scalar SpGEMM plans; the returned function
    ``a_fine_data -> [scalar coarse payload per level]`` is numeric only
    (the scalar baseline's hot PtAP, paper Table 1): one device gather of
    the fine payload (its ``.expand_fine``), then ``ptap_numeric_data`` per level on the 1x1
    plans (``fused_pair_gemm`` at (1,1,1), ``block_seg_sum`` at 1x1 on the
    card).  The scalar product pattern of expanded operators equals the
    expansion of the blocked product pattern, so each level's output feeds
    the next level's PtAP directly.  ``**kw`` (``path=``) flows to every
    product.  Each operator's expansion is the setup's cached one
    (``_structures``)."""
    stages, structs = [], _structures(setupd)
    for ls, (a_st, p_st) in zip(setupd.levels, structs):
        P_s = expand_bcsr(ls.P, p_st)
        stages.append((ptap_symbolic(expand_bcsr(ls.A0, a_st), P_s),
                       P_s.data))
    emap0 = torch.as_tensor(structs[0][0][2], device=setupd.device) \
        if structs else None

    def expand_fine(a_fine_data: torch.Tensor) -> torch.Tensor:
        return a_fine_data.reshape(-1)[emap0].reshape(-1, 1, 1)

    def chain(a_fine_data: torch.Tensor, **kw) -> List[torch.Tensor]:
        s_data = expand_fine(a_fine_data)
        outs = []
        for cache_s, p_data in stages:
            s_data = ptap_numeric_data(cache_s, s_data, p_data, **kw)
            outs.append(s_data)
        return outs

    chain.stages = stages
    chain.expand_fine = expand_fine
    return chain


def recompute_scalar(setupd: GAMGSetup, a_fine_data: torch.Tensor
                     ) -> Hierarchy:
    """Numeric hierarchy rebuild with scalar-CSR level and transfer
    operators.

    The PtAP chain itself still runs blocked (the paper's production
    structure: the baseline differs in the solve-phase format); the
    scalar-format PtAP is ``build_scalar_ptap_chain``'s.  Honours
    ``setupd.precision`` as ``gamg.recompute`` does: payloads at the
    hierarchy dtype, the blocked ``dinv`` and ``lam_max`` of
    ``gamg.level_state``, and under a mixed policy a krylov-dtype copy of
    the expanded finest operator (``Hierarchy.a_fine_ell``)."""
    policy = setupd.precision
    h = policy.hierarchy_dtype
    plans = scalar_levels(setupd)
    states = []
    a_data = a_fine_data.to(h)
    for ls, sl in zip(setupd.levels, plans):
        blocked = level_state(ls, a_data, policy)    # reuse dinv + lam
        states.append(LevelState(
            a_ell=sl.a_plan.build(a_data.reshape(-1, 1, 1)),
            p_ell=_at(sl.p_ell, h), r_ell=_at(sl.r_ell, h),
            dinv=blocked.dinv, lam_max=blocked.lam_max))
        a_data = ptap_numeric_data(ls.ptap_cache, a_data, ls.P.data.to(h),
                                   accum_dtype=policy.kernel_accum_dtype)
    chol = coarse_cholesky(_coarse_dense(setupd, a_data), policy)
    a_fine_ell = None
    if policy.mixed and setupd.levels:
        # the fp64 outer CG must never apply the reduced-precision
        # operator, or its residual monitor lies
        a_fine_ell = plans[0].a_plan.build(
            a_fine_data.to(policy.krylov_dtype).reshape(-1, 1, 1))
    return Hierarchy(levels=tuple(states), coarse_chol=chol,
                     a_fine_ell=a_fine_ell)
