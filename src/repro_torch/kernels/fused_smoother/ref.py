"""Plain PyTorch version of the fused smoother recurrence step."""
from __future__ import annotations

import torch


def smoother_step_ref(indices: torch.Tensor, data: torch.Tensor,
                      dinv: torch.Tensor, b_blocks: torch.Tensor,
                      x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                      coef: torch.Tensor):
    """One step ``d' = c1 d + c2 D^-1 (b - A x)``, ``x' = x + d'`` over
    ``(nbr, bs)`` block vectors or ``(nbr, bs, k)`` panels, A in padded
    BlockELL form, ``coef = [c1, c2]``.  Returns ``(x', d')``."""
    xg = x_blocks[indices.long()]                 # (nbr, kmax, bs[, k])
    r = b_blocks - torch.einsum("rkab,rkb...->ra...", data, xg)
    z = torch.einsum("rab,rb...->ra...", dinv, r)
    d_new = coef[0] * d_blocks + coef[1] * z
    return x_blocks + d_new, d_new
