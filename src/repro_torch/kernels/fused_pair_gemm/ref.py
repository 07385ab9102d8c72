"""Plain PyTorch version of the fused tiled pair-GEMM (gather, contract,
reduce)."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator, contract_dtype


def fused_pair_gemm_ref(a_data: torch.Tensor, b_data: torch.Tensor,
                        tile_a: torch.Tensor, tile_b: torch.Tensor,
                        tile_mask: torch.Tensor, *,
                        accum_dtype=None) -> torch.Tensor:
    """``out[s] = sum_k mask[s,k] * a_data[tile_a[s,k]] @ b_data[tile_b[s,k]]``
    -> ``(rows, br, bc)`` at ``a_data.dtype``: gathers both operands,
    zeroes the padded lhs slots and contracts over the ``kmax`` slots at
    ``accum_dtype`` (None: the payload's; bf16 sums at f32), rounded
    once."""
    rows = tile_a.shape[0]
    br, bc = a_data.shape[1], b_data.shape[2]
    if tile_a.shape[1] == 0:
        return torch.zeros((rows, br, bc), dtype=a_data.dtype,
                           device=a_data.device)
    c = contract_dtype(accumulator(a_data.dtype, accum_dtype))
    lhs = a_data[tile_a.long()].to(c)            # (rows, kmax, br, bk)
    lhs = torch.where(tile_mask[..., None, None], lhs,
                      torch.zeros((), dtype=c, device=lhs.device))
    rhs = b_data[tile_b.long()].to(c)            # (rows, kmax, bk, bc)
    return torch.einsum("skij,skjl->sil", lhs, rhs).to(a_data.dtype)
