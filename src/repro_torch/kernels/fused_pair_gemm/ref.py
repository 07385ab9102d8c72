"""Plain PyTorch version of the fused tiled pair-GEMM (gather, contract,
reduce)."""
from __future__ import annotations

import torch


def fused_pair_gemm_ref(a_data: torch.Tensor, b_data: torch.Tensor,
                        tile_a: torch.Tensor, tile_b: torch.Tensor,
                        tile_mask: torch.Tensor) -> torch.Tensor:
    """``out[s] = sum_k mask[s,k] * a_data[tile_a[s,k]] @ b_data[tile_b[s,k]]``
    -> ``(rows, br, bc)``: gathers both operands, zeroes the padded lhs
    slots and contracts over the ``kmax`` slots."""
    rows = tile_a.shape[0]
    br, bc = a_data.shape[1], b_data.shape[2]
    if tile_a.shape[1] == 0:
        return torch.zeros((rows, br, bc), dtype=a_data.dtype,
                           device=a_data.device)
    lhs = a_data[tile_a.long()]                  # (rows, kmax, br, bk)
    lhs = torch.where(tile_mask[..., None, None], lhs,
                      torch.zeros((), dtype=lhs.dtype, device=lhs.device))
    rhs = b_data[tile_b.long()]                  # (rows, kmax, bk, bc)
    return torch.einsum("skij,skjl->sil", lhs, rhs)
