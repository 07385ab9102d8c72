"""Plain PyTorch version of the batched rectangular block GEMM."""
from __future__ import annotations

import torch


def block_pair_gemm_ref(lhs: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``(npairs, br, bk) @ (npairs, bk, bc)`` -> ``(npairs, br, bc)``,
    accumulated over ``bk`` in order (the TPU kernel's loop)."""
    out = torch.zeros((lhs.shape[0], lhs.shape[1], rhs.shape[2]),
                      dtype=lhs.dtype, device=lhs.device)
    for j in range(lhs.shape[2]):
        out += lhs[:, :, j, None] * rhs[:, None, j, :]
    return out
