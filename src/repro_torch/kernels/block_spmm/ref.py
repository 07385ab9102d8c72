"""Plain PyTorch version of the blocked ELL SpMM (column panel)."""
from __future__ import annotations

import torch


def block_spmm_ell_ref(indices: torch.Tensor, data: torch.Tensor,
                       x_panels: torch.Tensor) -> torch.Tensor:
    """``(nbr, kmax)`` indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc,
    k)`` X -> ``(nbr, br, k)``.  Padded slots are zero blocks at column
    0."""
    xg = x_panels[indices.long()]                 # (nbr, kmax, bc, k)
    return torch.einsum("rkab,rkbm->ram", data, xg)
