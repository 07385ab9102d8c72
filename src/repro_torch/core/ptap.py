"""Galerkin triple product A_c = P^T A P with cached plans (torch twin of
``repro.core.ptap``; paper Sec. 3.5).

``ptap_symbolic(A, P)`` builds the prolongator-side ``PtAPCache`` once
(the transpose permutation on the host and both SpGEMM plans on the
operators' device, structure only); ``ptap_numeric_data`` is the hot
PtAP: two cached numeric SpGEMMs on the device, no symbolic work.
``ptap`` is the front door with PETSc's state gate: the cache is reused
while P's and A's structure tokens (``BlockCSR.state_token``) are the
ones it was built for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR, device_array, \
    transpose_structure
from repro_torch.core.spgemm import (
    SpGEMMPlan,
    _work_device,
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
    p_state: int = 0            # state gate: P's token at build time
    a_struct_state: int = 0     # A's structure token (values may change)


def _structure(indptr, indices, nbc, br, bc, dtype) -> BlockCSR:
    """A structure-only operand: a ``meta`` data tensor carries the block
    shape without storage."""
    data = torch.empty((len(indices), br, bc), dtype=dtype, device="meta")
    return BlockCSR(np.asarray(indptr), np.asarray(indices), data, nbc)


def ptap_symbolic(A: BlockCSR, P: BlockCSR) -> PtAPCache:
    """Cold symbolic phase: transpose plan + both SpGEMM plans (structure
    only; never touches A.data or P.data), the products' on the
    operators' device."""
    if A.nbc != P.nbr or A.bc != P.br:
        raise ValueError("A (f x f) must feed P (f x c)")
    r_indptr, r_indices, r_perm = transpose_structure(P.indptr, P.indices,
                                                      P.nbc)
    R = _structure(r_indptr, r_indices, P.nbr, P.bc, P.br, P.data.dtype)
    dev = _work_device(A, P)
    ap_plan = spgemm_symbolic(A, P, device=dev)
    AP = _structure(ap_plan.indptr, ap_plan.indices, ap_plan.nbc,
                    ap_plan.br, ap_plan.bc, A.data.dtype)
    ac_plan = spgemm_symbolic(R, AP, device=dev)
    return PtAPCache(r_indptr=r_indptr, r_indices=r_indices, r_perm=r_perm,
                     ap_plan=ap_plan, ac_plan=ac_plan, n_coarse=P.nbc,
                     p_state=P.state_token, a_struct_state=A.state_token)


def ptap_numeric_data(cache: PtAPCache, a_data: torch.Tensor,
                      p_data: torch.Tensor, **kw) -> torch.Tensor:
    """Hot PtAP: A @ P, then R @ (A P) with R's payload the permuted,
    block-transposed P payload.  ``path=`` flows to both products."""
    r_perm = device_array(cache, "r_perm", p_data.device)
    r_data = p_data[r_perm].transpose(1, 2).contiguous()
    ap_data = spgemm_numeric_data(cache.ap_plan, a_data, p_data, **kw)
    return spgemm_numeric_data(cache.ac_plan, r_data, ap_data, **kw)


def ptap_numeric(cache: PtAPCache, A: BlockCSR, P: BlockCSR, **kw
                 ) -> BlockCSR:
    """Hot PtAP on the operands' payloads -> the coarse ``BlockCSR``."""
    data = ptap_numeric_data(cache, A.data, P.data, **kw)
    return BlockCSR.from_arrays(cache.ac_plan.indptr, cache.ac_plan.indices,
                                data, cache.n_coarse)


def ptap(A: BlockCSR, P: BlockCSR, cache: Optional[PtAPCache] = None,
         **kw) -> Tuple[BlockCSR, PtAPCache]:
    """Front door with the state gate (PETSc's MAT_REUSE_MATRIX): a cache
    built for P's and A's current structure tokens is reused, anything
    else is rebuilt symbolically.  Returns ``(A_c, cache)``."""
    gate_ok = (cache is not None and cache.p_state == P.state_token
               and cache.a_struct_state == A.state_token)
    if not gate_ok:
        cache = ptap_symbolic(A, P)
    return ptap_numeric(cache, A, P, **kw), cache


def galerkin_flops(cache: PtAPCache, bs_f: int) -> int:
    """Useful flop count of the numeric phase (the traffic model's)."""
    ap, ac = cache.ap_plan, cache.ac_plan
    return (2 * ap.npairs * ap.br * bs_f * ap.bc
            + 2 * ac.npairs * ac.br * bs_f * ac.bc)
