"""Wrapper of the blocked ELL SpMM kernel (``csrc/block_spmm.cu``).

Every panel operator product of the multi-RHS solve runs through here
(``repro_torch.core.spmv.spmm_ell``): CG's ``A P``, the V-cycle residual
and prolongation on ``(n, k)`` panels.  ``k`` is a runtime argument of
the kernel; nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL
from repro_torch.kernels import autotune, backend
from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref

SHAPES = ((3, 3), (3, 6), (6, 6))
_ARGS = (backend.P,) * 4 + (backend.I,) * 6 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def block_spmm_ell(indices: torch.Tensor, data: torch.Tensor,
                   x_panels: torch.Tensor, *,
                   threads: int | None = None) -> torch.Tensor:
    """Y = A X with A in padded BlockELL form: int32 ``(nbr, kmax)``
    indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc, k)`` X -> ``(nbr,
    br, k)``.  ``threads`` (one per (block row, column)) ``None`` resolves
    through the autotuner (static default 256).  CPU tensors take the
    plain version; CUDA tensors the kernel."""
    global launches
    name = "block_spmm"
    if x_panels.ndim != 3 or x_panels.shape[2] <= 0:
        raise ValueError(f"{name}: X must be an (nbc, bc, k) panel with "
                         f"k >= 1, got {tuple(x_panels.shape)}")
    cuda = backend.on_cuda(name, indices=indices, data=data, x=x_panels)
    nbr, kmax, br, bc = data.shape
    k = x_panels.shape[2]
    threads = autotune.launch_threads(
        name, autotune.signature(data.dtype, nbr * k, br=br, bc=bc,
                                 kmax=kmax, k=k), threads, data.device)
    if not cuda:
        return block_spmm_ell_ref(indices, data, x_panels)
    if (br, bc) not in SHAPES:
        raise ValueError(f"{name}: block shape {(br, bc)} has no kernel "
                         f"instantiation (have {SHAPES})")
    if tuple(indices.shape) != (nbr, kmax) or x_panels.shape[1] != bc:
        raise ValueError(f"{name}: shapes {tuple(indices.shape)}, "
                         f"{tuple(data.shape)}, {tuple(x_panels.shape)} "
                         f"disagree")
    backend.check_kernel_args(name, dict(data=data, x=x_panels),
                              dict(indices=indices))
    y = torch.empty((nbr, br, k), dtype=data.dtype, device=data.device)
    backend.launch("repro_block_spmm_f64", _ARGS, backend.ptr(indices),
                   backend.ptr(data), backend.ptr(x_panels), backend.ptr(y),
                   nbr, kmax, br, bc, k, threads)
    launches += 1
    return y


def block_spmm(ell: BlockELL, X: torch.Tensor, *,
               threads: int | None = None) -> torch.Tensor:
    """Y = A X on flat panels: ``(nbc*bc, k)`` -> ``(nbr*br, k)``."""
    k = X.shape[1]
    y = block_spmm_ell(ell.indices, ell.data, X.reshape(ell.nbc, ell.bc, k),
                       threads=threads)
    return y.reshape(ell.nbr * ell.br, k)
