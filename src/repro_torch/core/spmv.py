"""Blocked SpMV (torch twin of ``repro.core.spmv``, vector case).

The blocked SpMV moves one 4-byte column index per ``br x bc`` block
instead of ``br*bc`` indexed scalars.  In the reference, ``apply_ell``'s
vector branch is jnp ``spmv_ell`` and never reaches the Pallas kernel; in
the port every ``A x`` / ``P x`` runs through the hand-written
``block_spmv`` kernel (its plain version on CPU tensors).  The
transpose-free restriction ``apply_ell_t`` had no Pallas kernel and stays
plain torch.
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL, EllTransposePlan, \
    device_array
from repro_torch.kernels.block_spmv import ops as spmv_ops


def spmv_ell(ell: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x on the padded ELL layout.  x: (nbc*bc,) -> y: (nbr*br,)."""
    return spmv_ops.block_spmv(ell, x)


def apply_ell(ell: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """ELL apply of a vector (the panel case waits for the multi-RHS
    slice)."""
    if x.ndim != 1:
        raise ValueError("repro_torch applies operators to vectors; panel "
                         "solves are not ported yet")
    return spmv_ell(ell, x)


def apply_ell_t(ell: BlockELL, pt: EllTransposePlan,
                x: torch.Tensor) -> torch.Tensor:
    """y = A^T @ x straight off A's ELL blocks (transpose-free
    restriction): gathers the blocks each output row needs through ``pt``
    and contracts them transposed.  Padded plan slots point at slot 0 and
    are zeroed by the mask."""
    nbr, kmax, br, bc = ell.data.shape
    dev = x.device
    gather = device_array(pt, "gather", dev)
    blocks = ell.data.reshape(nbr * kmax, br, bc)[gather]
    mask = device_array(pt, "mask", dev, torch.bool)[..., None, None]
    blocks = torch.where(mask, blocks,
                         torch.zeros((), dtype=blocks.dtype, device=dev))
    xg = x.reshape(nbr, br)[device_array(pt, "rows", dev)]
    y = torch.einsum("ckab,cka->cb", blocks, xg)
    return y.reshape(ell.nbc * bc)
