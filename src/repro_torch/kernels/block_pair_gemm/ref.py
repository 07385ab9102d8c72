"""Plain PyTorch version of the batched rectangular block GEMM."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator, contract_dtype


def block_pair_gemm_ref(lhs: torch.Tensor, rhs: torch.Tensor, *,
                        accum_dtype=None, out_dtype=None) -> torch.Tensor:
    """``(npairs, br, bk) @ (npairs, bk, bc)`` -> ``(npairs, br, bc)``,
    accumulated over ``bk`` in order (the TPU kernel's loop) at
    ``accum_dtype`` (None: ``lhs.dtype``; bf16 sums at f32), rounded once
    to ``out_dtype`` (None: ``lhs.dtype``)."""
    c = contract_dtype(accumulator(lhs.dtype, accum_dtype))
    a, b = lhs.to(c), rhs.to(c)
    out = torch.zeros((lhs.shape[0], lhs.shape[1], rhs.shape[2]), dtype=c,
                      device=lhs.device)
    for j in range(lhs.shape[2]):
        out += a[:, :, j, None] * b[:, None, j, :]
    return out.to(out_dtype or lhs.dtype)
