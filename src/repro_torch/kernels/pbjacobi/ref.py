"""Plain PyTorch version of the fused pbjacobi update."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator, contract_dtype


def pbjacobi_update_ref(dinv: torch.Tensor, r_blocks: torch.Tensor,
                        x_blocks: torch.Tensor, omega, *,
                        accum_dtype=None) -> torch.Tensor:
    """``x + omega * D^-1 r`` over ``(nbr, bs)`` block vectors, ``dinv``
    ``(nbr, bs, bs)``, at ``dinv.dtype``; ``omega`` a number or a
    one-element tensor, rounded to the accumulator (the reference's
    ``accum_dtype`` rule)."""
    acc = accumulator(dinv.dtype, accum_dtype)
    y = torch.einsum("nab,nb->na", dinv.to(contract_dtype(acc)),
                     r_blocks.to(contract_dtype(acc))).to(acc)
    if isinstance(omega, torch.Tensor):
        w = omega.reshape(()).to(acc)
    else:
        w = torch.full((), omega, dtype=acc, device=dinv.device)
    return (x_blocks.to(acc) + w * y).to(dinv.dtype)
