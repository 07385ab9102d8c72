"""Prolongator smoothing P = (I - omega D^-1 A) P~ (torch twin of
``repro.core.smooth``; paper Sec. 2.2).

All blocked: ``D^-1`` is the batched inverse of the diagonal blocks,
``D^-1 A`` a block-row scaling of A's payloads, the product with P~ the
cached two-phase SpGEMM and the subtraction the native block AXPY over the
union sparsity.  ``omega = (4/3) / lambda_max(D^-1 A)`` with lambda_max from
a short device power iteration whose products run through ``block_spmv``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.block_csr import BlockCSR
from repro_torch.core.spgemm import (
    BlockAXPYPlan,
    SpGEMMPlan,
    block_axpy_numeric_data,
    block_axpy_symbolic,
    spgemm_numeric_data,
    spgemm_symbolic,
)
from repro_torch.kernels.block_spmv import ops as spmv_ops


def invert_diag_blocks(diag: torch.Tensor) -> torch.Tensor:
    """Batched small-block inverse; the pbjacobi setup.  Row-major, as the
    kernels read it (the batched CUDA inverse returns column-major
    blocks)."""
    return torch.linalg.inv(diag).contiguous()


def scale_rows_data(A: BlockCSR, dinv: torch.Tensor) -> torch.Tensor:
    """Payloads of D^-1 A: left-multiply each block by its row's D^-1."""
    rows = torch.as_tensor(A.row_of_nnz(), device=A.device)
    return torch.einsum("nab,nbc->nac", dinv[rows], A.data)


def lambda_max_dinv_a(ell_indices: torch.Tensor, dinva_ell_data: torch.Tensor,
                      iters: int = 10) -> torch.Tensor:
    """lambda_max(D^-1 A) by power iteration on the ELL layout; a device
    scalar (no host sync)."""
    nbr, _, bs, _ = dinva_ell_data.shape
    tiny = torch.finfo(dinva_ell_data.dtype).tiny

    def spmv(xb):
        return spmv_ops.block_spmv_ell(ell_indices, dinva_ell_data, xb)

    x = torch.ones((nbr, bs), dtype=dinva_ell_data.dtype,
                   device=dinva_ell_data.device)
    x = x / torch.linalg.vector_norm(x)
    for _ in range(iters):
        y = spmv(x)
        x = y / torch.clamp_min(torch.linalg.vector_norm(y), tiny)
    return torch.linalg.vector_norm(spmv(x))


def smoothed_prolongator(A: BlockCSR, P_tent: BlockCSR,
                         omega_scale: float = 4.0 / 3.0,
                         lam_max: Optional[torch.Tensor] = None
                         ) -> Tuple[BlockCSR, torch.Tensor, torch.Tensor,
                                    dict]:
    """One damped-Jacobi smoothing step of the tentative prolongator.
    Returns (P, omega, lam_max, plans)."""
    dinv = invert_diag_blocks(A.diagonal_blocks())
    dinva_data = scale_rows_data(A, dinv)
    if lam_max is None:
        plan = A.ell_plan()
        ell = plan.build(dinva_data)
        lam_max = lambda_max_dinv_a(ell.indices, ell.data)
    omega = omega_scale / lam_max
    DinvA = A.with_data(dinva_data)
    ap_plan = spgemm_symbolic(DinvA, P_tent)
    ap_data = spgemm_numeric_data(ap_plan, dinva_data, P_tent.data)
    AP = BlockCSR.from_arrays(ap_plan.indptr, ap_plan.indices, ap_data,
                              ap_plan.nbc)
    axpy_plan = block_axpy_symbolic(AP, P_tent)
    p_data = block_axpy_numeric_data(axpy_plan, -omega, ap_data, P_tent.data)
    P = BlockCSR.from_arrays(axpy_plan.indptr, axpy_plan.indices, p_data,
                             axpy_plan.nbc)
    return P, omega, lam_max, dict(ap_plan=ap_plan, axpy_plan=axpy_plan)


def resmooth_prolongator_data(ap_plan: SpGEMMPlan, axpy_plan: BlockAXPYPlan,
                              a_data: torch.Tensor, dinv: torch.Tensor,
                              omega: torch.Tensor, p_tent_data: torch.Tensor,
                              row_of_nnz: torch.Tensor) -> torch.Tensor:
    """Hot numeric re-smoothing with cached plans (new A values, the same
    tentative prolongator): ``P = P~ - omega D^-1 A P~``."""
    dinva = torch.einsum("nab,nbc->nac", dinv[row_of_nnz], a_data)
    ap = spgemm_numeric_data(ap_plan, dinva.contiguous(), p_tent_data)
    return block_axpy_numeric_data(axpy_plan, -omega, ap, p_tent_data)
