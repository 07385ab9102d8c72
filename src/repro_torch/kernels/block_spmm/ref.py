"""Plain PyTorch version of the blocked ELL SpMM (column panel)."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator, contract_dtype


def block_spmm_ell_ref(indices: torch.Tensor, data: torch.Tensor,
                       x_panels: torch.Tensor, *,
                       accum_dtype=None) -> torch.Tensor:
    """``(nbr, kmax)`` indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc,
    k)`` X -> ``(nbr, br, k)`` at ``data.dtype``.  Padded slots are zero
    blocks at column 0.  ``accum_dtype`` as in ``block_spmv_ell_ref``."""
    c = contract_dtype(accumulator(data.dtype, accum_dtype))
    xg = x_panels[indices.long()]                 # (nbr, kmax, bc, k)
    return torch.einsum("rkab,rkbm->ram", data.to(c),
                        xg.to(c)).to(data.dtype)
