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


def smoother_step_scalar_ref(indices: torch.Tensor, data: torch.Tensor,
                             dinv: torch.Tensor, b_blocks: torch.Tensor,
                             x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                             coef: torch.Tensor, *, accum_dtype=None):
    """The step on scalar rows with node blocks: A in 1x1 ELL rows,
    ``(nbr*bs, kmax)`` indices and ``(nbr*bs, kmax, 1, 1)`` data, ``dinv
    (nbr, bs, bs)``, ``(nbr, bs)`` node vectors (or ``(nbr, bs, k)``
    panels); node ``I`` owns scalar rows ``I*bs .. I*bs+bs-1``.  Returns
    ``(x', d')`` at ``data.dtype``, at ``smoother_step_ref``'s
    accumulator rule."""
    acc = accumulator(data.dtype, accum_dtype)
    c = contract_dtype(acc)
    shape = tuple(b_blocks.shape)
    xs = x_blocks.reshape((-1,) + shape[2:])      # scalar rows
    xg = xs[indices.long()]                       # (nrows, kmax[, k])
    ax = torch.einsum("rk,rk...->r...", data[..., 0, 0].to(c),
                      xg.to(c)).to(acc).reshape(shape)
    r = b_blocks.to(acc) - ax
    z = torch.einsum("rab,rb...->ra...", dinv.to(c), r.to(c)).to(acc)
    cf = coef.to(acc)
    d_new = cf[0] * d_blocks.to(acc) + cf[1] * z
    x_new = x_blocks.to(acc) + d_new
    return x_new.to(data.dtype), d_new.to(data.dtype)
