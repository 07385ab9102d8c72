"""Plain PyTorch version of the fused pbjacobi update."""
from __future__ import annotations

import torch


def pbjacobi_update_ref(dinv: torch.Tensor, r_blocks: torch.Tensor,
                        x_blocks: torch.Tensor, omega) -> torch.Tensor:
    """``x + omega * D^-1 r`` over ``(nbr, bs)`` block vectors, ``dinv``
    ``(nbr, bs, bs)``, in f64; ``omega`` a number or a one-element
    tensor."""
    if isinstance(omega, torch.Tensor):
        omega = omega.reshape(())
    return x_blocks + omega * torch.einsum("nab,nb->na", dinv, r_blocks)
