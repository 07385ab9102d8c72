"""Blocked SpMV / SpMM (torch twin of ``repro.core.spmv``).

The blocked SpMV moves one 4-byte column index per ``br x bc`` block
instead of ``br*bc`` indexed scalars; the panel SpMM shares that operator
stream between the ``k`` columns of a multi-RHS panel.  In the reference,
``apply_ell``'s vector branch is jnp ``spmv_ell`` and never reaches the
Pallas kernel; in the port every ``A x`` / ``P x`` runs through the
hand-written ``block_spmv`` kernel and every ``A X`` / ``P X`` on a panel
of ``k >= 2`` columns through ``block_spmm`` (their plain versions on CPU
tensors).  A width-1 panel goes through ``block_spmv``, so it is bitwise
the vector apply.  The transpose-free restriction ``apply_ell_t`` had no
Pallas kernel and stays plain torch.  ``spmv`` / ``spmm`` take a
``BlockCSR`` or a ``BlockELL``; the reference's ``use_kernel`` /
``interpret`` / ``tile_rows`` knobs have no port counterpart (a CUDA
payload always launches the kernel, and ``threads`` is the autotuner's
knob).  ``spmv_bcsr_ref`` and ``spmv_csr_ref`` are the plain oracles
(blocked and scalar CSR, gather + segment sum).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.block_csr import BlockCSR, BlockELL, \
    EllTransposePlan, device_array
from repro_torch.kernels.block_spmm import ops as spmm_ops
from repro_torch.kernels.block_spmv import ops as spmv_ops
from repro_torch.obs import trace as obs_trace


@obs_trace.spanned("spmv_ell")
def spmv_ell(ell: BlockELL, x: torch.Tensor, *,
             accum_dtype=None) -> torch.Tensor:
    """y = A @ x on the padded ELL layout.  x: (nbc*bc,) -> y: (nbr*br,),
    at the payload dtype; ``accum_dtype`` is the kernels' accumulator rule
    (None: the payload's)."""
    return spmv_ops.block_spmv(ell, x, accum_dtype=accum_dtype)


@obs_trace.spanned("spmm_ell")
def spmm_ell(ell: BlockELL, X: torch.Tensor, *,
             accum_dtype=None) -> torch.Tensor:
    """Y = A @ X for a panel X: ``(nbc*bc, k)`` -> ``(nbr*br, k)``.  ``k ==
    1`` goes through ``spmv_ell``, so a single-column panel is bitwise the
    vector result."""
    if X.shape[1] == 1:
        return spmv_ell(ell, X[:, 0], accum_dtype=accum_dtype)[:, None]
    return spmm_ops.block_spmm(ell, X, accum_dtype=accum_dtype)


def spmv(A, x: torch.Tensor, *, threads: int | None = None,
         accum_dtype=None) -> torch.Tensor:
    """Front door: y = A @ x, A a BlockCSR (converted) or a BlockELL."""
    ell = A.to_ell() if isinstance(A, BlockCSR) else A
    return spmv_ops.block_spmv(ell, x, threads=threads,
                               accum_dtype=accum_dtype)


def residual(A, x: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """``b - A x`` through ``spmv`` (its knobs in ``kw``)."""
    return b - spmv(A, x, **kw)


def spmv_bcsr_ref(A: BlockCSR, x: torch.Tensor) -> torch.Tensor:
    """Plain SpMV straight off BCSR (gather + segment sum): the oracle of
    the property tests."""
    rows = torch.as_tensor(A.row_of_nnz(), device=A.device)
    xb = x.reshape(A.nbc, A.bc)
    idx = torch.as_tensor(A.indices.astype(np.int64), device=A.device)
    contrib = torch.einsum("nab,nb->na", A.data, xb[idx])
    y = torch.zeros((A.nbr, A.br), dtype=contrib.dtype, device=A.device)
    return y.index_add_(0, rows, contrib).reshape(A.nbr * A.br)


def spmv_csr_ref(indices: torch.Tensor, data: torch.Tensor,
                 row_of_nnz: torch.Tensor, nrows: int,
                 x: torch.Tensor) -> torch.Tensor:
    """Scalar CSR SpMV, gather + sorted segment sum (the AIJ baseline)."""
    contrib = data * x[indices.long()]
    y = torch.zeros(nrows, dtype=contrib.dtype, device=contrib.device)
    return y.index_add_(0, row_of_nnz.long(), contrib)


def block_diag_apply(diag_inv: torch.Tensor, x: torch.Tensor,
                     transpose_blocks: bool = False) -> torch.Tensor:
    """``y_i = D_i^-1 x_i`` from pre-inverted ``(nbr, bs, bs)`` diagonal
    blocks (the pbjacobi apply); ``transpose_blocks`` applies each block
    transposed."""
    nbr, bs = diag_inv.shape[0], diag_inv.shape[1]
    eq = "nba,nb->na" if transpose_blocks else "nab,nb->na"
    return torch.einsum(eq, diag_inv, x.reshape(nbr, bs)).reshape(-1)


def spmm(A, X: torch.Tensor, *, accum_dtype=None) -> torch.Tensor:
    """Multi-RHS front door: Y = A @ X, X ``(n, k)``, A a BlockCSR
    (converted) or a BlockELL."""
    ell = A.to_ell() if isinstance(A, BlockCSR) else A
    return spmm_ell(ell, X, accum_dtype=accum_dtype)


def apply_ell(ell: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Shape-polymorphic ELL apply: ``(n,)`` -> ``spmv_ell``, ``(n, k)`` ->
    ``spmm_ell``.  The V-cycle and both Krylov loops route every operator
    application through here, so the whole hierarchy takes panels."""
    return spmv_ell(ell, x) if x.ndim == 1 else spmm_ell(ell, x)


@obs_trace.spanned("apply_ell_t")
def apply_ell_t(ell: BlockELL, pt: EllTransposePlan,
                x: torch.Tensor) -> torch.Tensor:
    """y = A^T @ x straight off A's ELL blocks (transpose-free
    restriction): gathers the blocks each output row needs through ``pt``
    and contracts them transposed.  Padded plan slots point at slot 0 and
    are zeroed by the mask.  ``x`` is ``(nbr*br,)`` or a panel
    ``(nbr*br, k)``."""
    nbr, kmax, br, bc = ell.data.shape
    dev = x.device
    gather = device_array(pt, "gather", dev)
    blocks = ell.data.reshape(nbr * kmax, br, bc)[gather]
    mask = device_array(pt, "mask", dev, torch.bool)[..., None, None]
    blocks = torch.where(mask, blocks,
                         torch.zeros((), dtype=blocks.dtype, device=dev))
    xb = x.reshape((nbr, br) + tuple(x.shape[1:]))
    xg = xb[device_array(pt, "rows", dev)]      # (nbc, tkmax, br[, k])
    y = torch.einsum("ckab,cka...->cb...", blocks, xg)
    # einsum may return permuted strides; the kernels take row-major panels
    return y.contiguous().reshape((ell.nbc * bc,) + tuple(x.shape[1:]))
