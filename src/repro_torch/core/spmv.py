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
Pallas kernel and stays plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockCSR, BlockELL, \
    EllTransposePlan, device_array
from repro_torch.kernels.block_spmm import ops as spmm_ops
from repro_torch.kernels.block_spmv import ops as spmv_ops


def spmv_ell(ell: BlockELL, x: torch.Tensor, *,
             accum_dtype=None) -> torch.Tensor:
    """y = A @ x on the padded ELL layout.  x: (nbc*bc,) -> y: (nbr*br,),
    at the payload dtype; ``accum_dtype`` is the kernels' accumulator rule
    (None: the payload's)."""
    return spmv_ops.block_spmv(ell, x, accum_dtype=accum_dtype)


def spmm_ell(ell: BlockELL, X: torch.Tensor, *,
             accum_dtype=None) -> torch.Tensor:
    """Y = A @ X for a panel X: ``(nbc*bc, k)`` -> ``(nbr*br, k)``.  ``k ==
    1`` goes through ``spmv_ell``, so a single-column panel is bitwise the
    vector result."""
    if X.shape[1] == 1:
        return spmv_ell(ell, X[:, 0], accum_dtype=accum_dtype)[:, None]
    return spmm_ops.block_spmm(ell, X, accum_dtype=accum_dtype)


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
