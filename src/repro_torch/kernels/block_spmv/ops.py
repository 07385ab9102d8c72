"""Wrapper of the blocked ELL SpMV kernel (``csrc/block_spmv.cu``).

Every operator product of the solve runs through here: CG's ``A p``, the
V-cycle residual and prolongation, and the ``lambda_max`` power iteration.
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL
from repro_torch.kernels import autotune, backend
from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref

SHAPES = ((3, 3), (3, 6), (6, 6))
_ARGS = (backend.P,) * 4 + (backend.I,) * 5 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def block_spmv_ell(indices: torch.Tensor, data: torch.Tensor,
                   x_blocks: torch.Tensor, *,
                   threads: int | None = None) -> torch.Tensor:
    """y = A x with A in padded BlockELL form: int32 ``(nbr, kmax)``
    indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc)`` x -> ``(nbr, br)``.
    ``threads`` (one per block row) ``None`` resolves through the
    autotuner (static default 256).  CPU tensors take the plain version;
    CUDA tensors the kernel."""
    global launches
    name = "block_spmv"
    cuda = backend.on_cuda(name, indices=indices, data=data, x=x_blocks)
    nbr, kmax, br, bc = data.shape
    threads = autotune.launch_threads(
        name, autotune.signature(data.dtype, nbr, br=br, bc=bc, kmax=kmax),
        threads, data.device)
    if not cuda:
        return block_spmv_ell_ref(indices, data, x_blocks)
    if (br, bc) not in SHAPES:
        raise ValueError(f"{name}: block shape {(br, bc)} has no kernel "
                         f"instantiation (have {SHAPES})")
    if tuple(indices.shape) != (nbr, kmax) or x_blocks.shape[1] != bc:
        raise ValueError(f"{name}: shapes {tuple(indices.shape)}, "
                         f"{tuple(data.shape)}, {tuple(x_blocks.shape)} "
                         f"disagree")
    backend.check_kernel_args(name, dict(data=data, x=x_blocks),
                              dict(indices=indices))
    y = torch.empty((nbr, br), dtype=data.dtype, device=data.device)
    backend.launch("repro_block_spmv_f64", _ARGS, backend.ptr(indices),
                   backend.ptr(data), backend.ptr(x_blocks), backend.ptr(y),
                   nbr, kmax, br, bc, threads)
    launches += 1
    return y


def block_spmv(ell: BlockELL, x: torch.Tensor, *,
               threads: int | None = None) -> torch.Tensor:
    """y = A x on flat vectors: ``(nbc*bc,)`` -> ``(nbr*br,)``."""
    y = block_spmv_ell(ell.indices, ell.data, x.reshape(ell.nbc, ell.bc),
                       threads=threads)
    return y.reshape(ell.nbr * ell.br)
