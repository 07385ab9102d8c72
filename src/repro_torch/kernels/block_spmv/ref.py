"""Plain PyTorch version of the blocked ELL SpMV."""
from __future__ import annotations

import torch


def block_spmv_ell_ref(indices: torch.Tensor, data: torch.Tensor,
                       x_blocks: torch.Tensor) -> torch.Tensor:
    """``(nbr, kmax)`` indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc)``
    x -> ``(nbr, br)``.  Padded slots are zero blocks at column 0."""
    xg = x_blocks[indices.long()]                 # (nbr, kmax, bc)
    return torch.einsum("rkab,rkb->ra", data, xg)
