"""Plain PyTorch version of the blocked ELL SpMV."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator, contract_dtype


def block_spmv_ell_ref(indices: torch.Tensor, data: torch.Tensor,
                       x_blocks: torch.Tensor, *,
                       accum_dtype=None) -> torch.Tensor:
    """``(nbr, kmax)`` indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc)``
    x -> ``(nbr, br)`` at ``data.dtype``.  Padded slots are zero blocks at
    column 0.  ``accum_dtype`` is the reference's accumulator rule:
    contract there (a bf16 accumulator sums at f32), round once."""
    c = contract_dtype(accumulator(data.dtype, accum_dtype))
    xg = x_blocks[indices.long()]                 # (nbr, kmax, bc)
    return torch.einsum("rkab,rkb->ra", data.to(c),
                        xg.to(c)).to(data.dtype)
