"""Galerkin triple product A_c = P^T A P with cached plans (torch twin of
``repro.core.ptap``; paper Sec. 3.5).

``ptap_symbolic(A, P)`` builds the prolongator-side ``PtAPCache`` once on
the host (the transpose permutation and both SpGEMM plans, structure
only); ``ptap_numeric_data`` is the hot PtAP: two cached numeric SpGEMMs
on the device, no symbolic work.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR, device_array, \
    transpose_structure
from repro_torch.core.spgemm import (
    SpGEMMPlan,
    spgemm_numeric_data,
    spgemm_symbolic,
)


@dataclasses.dataclass(frozen=True)
class PtAPCache:
    """Prolongator-side cached data, valid while (P, A) structures hold."""

    r_indptr: np.ndarray        # R = P^T structure
    r_indices: np.ndarray
    r_perm: np.ndarray          # numeric transpose permutation
    ap_plan: SpGEMMPlan         # A @ P
    ac_plan: SpGEMMPlan         # R @ (A @ P)
    n_coarse: int               # coarse block dim


def _structure(indptr, indices, nbc, br, bc, dtype) -> BlockCSR:
    """A structure-only operand: a ``meta`` data tensor carries the block
    shape without storage."""
    data = torch.empty((len(indices), br, bc), dtype=dtype, device="meta")
    return BlockCSR(np.asarray(indptr), np.asarray(indices), data, nbc)


def ptap_symbolic(A: BlockCSR, P: BlockCSR) -> PtAPCache:
    """Cold symbolic phase: transpose plan + both SpGEMM plans (structure
    only; never touches A.data or P.data)."""
    if A.nbc != P.nbr or A.bc != P.br:
        raise ValueError("A (f x f) must feed P (f x c)")
    r_indptr, r_indices, r_perm = transpose_structure(P.indptr, P.indices,
                                                      P.nbc)
    R = _structure(r_indptr, r_indices, P.nbr, P.bc, P.br, P.data.dtype)
    ap_plan = spgemm_symbolic(A, P)
    AP = _structure(ap_plan.indptr, ap_plan.indices, ap_plan.nbc,
                    ap_plan.br, ap_plan.bc, A.data.dtype)
    ac_plan = spgemm_symbolic(R, AP)
    return PtAPCache(r_indptr=r_indptr, r_indices=r_indices, r_perm=r_perm,
                     ap_plan=ap_plan, ac_plan=ac_plan, n_coarse=P.nbc)


def ptap_numeric_data(cache: PtAPCache, a_data: torch.Tensor,
                      p_data: torch.Tensor, **kw) -> torch.Tensor:
    """Hot PtAP: A @ P, then R @ (A P) with R's payload the permuted,
    block-transposed P payload.  ``path=`` flows to both products."""
    r_perm = device_array(cache, "r_perm", p_data.device)
    r_data = p_data[r_perm].transpose(1, 2).contiguous()
    ap_data = spgemm_numeric_data(cache.ap_plan, a_data, p_data, **kw)
    return spgemm_numeric_data(cache.ac_plan, r_data, ap_data, **kw)
