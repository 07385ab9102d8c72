"""Plain PyTorch version of the fused smoother recurrence step."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator, contract_dtype


def smoother_step_ref(indices: torch.Tensor, data: torch.Tensor,
                      dinv: torch.Tensor, b_blocks: torch.Tensor,
                      x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                      coef: torch.Tensor, *, accum_dtype=None):
    """One step ``d' = c1 d + c2 D^-1 (b - A x)``, ``x' = x + d'`` over
    ``(nbr, bs)`` block vectors or ``(nbr, bs, k)`` panels, A in padded
    BlockELL form, ``coef = [c1, c2]``.  Returns ``(x', d')`` at
    ``data.dtype``.  ``accum_dtype`` is the reference's accumulator rule:
    every step at the accumulator (each contraction summed at f32 and
    rounded once when it is bf16), the results rounded once."""
    acc = accumulator(data.dtype, accum_dtype)
    c = contract_dtype(acc)
    xg = x_blocks[indices.long()]                 # (nbr, kmax, bs[, k])
    ax = torch.einsum("rkab,rkb...->ra...", data.to(c), xg.to(c)).to(acc)
    r = b_blocks.to(acc) - ax
    z = torch.einsum("rab,rb...->ra...", dinv.to(c), r.to(c)).to(acc)
    cf = coef.to(acc)
    d_new = cf[0] * d_blocks.to(acc) + cf[1] * z
    x_new = x_blocks.to(acc) + d_new
    return x_new.to(data.dtype), d_new.to(data.dtype)
