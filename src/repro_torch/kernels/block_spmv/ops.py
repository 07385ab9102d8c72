"""Wrapper of the blocked ELL SpMV kernel (``csrc/block_spmv.cu``).

Every operator product of the solve runs through here: CG's ``A p``, the
V-cycle residual and prolongation, and the ``lambda_max`` power iteration;
at 1x1 blocks every ``A x``, ``P x`` and ``R r`` of the scalar (AIJ)
baseline (``core.scalar_path``).
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL
from repro_torch.kernels import autotune, backend, ell_rows
from repro_torch.kernels.block_spmv.ref import block_spmv_ell_ref
from repro_torch.obs import trace as obs_trace

SHAPES = ((3, 3), (3, 6), (6, 3), (6, 6), (1, 1))
_ARGS = (backend.P,) * 4 + (backend.I,) * 6 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)
#: the same launches by block shape ``(br, bc)``
launches_by_shape = dict.fromkeys(SHAPES, 0)


@obs_trace.spanned("kernels/block_spmv")
def block_spmv_ell(indices: torch.Tensor, data: torch.Tensor,
                   x_blocks: torch.Tensor, *, threads: int | None = None,
                   accum_dtype=None) -> torch.Tensor:
    """y = A x with A in padded BlockELL form: int32 ``(nbr, kmax)``
    indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc)`` x -> ``(nbr, br)``.
    Each block row takes ``ell_rows.lanes(br, bc, kmax)`` lanes;
    ``threads`` per CUDA block, ``None`` resolved through the autotuner
    (static default 256), only sets how many rows share a block.
    Payloads f64, f32 or bf16 at ``data.dtype``; ``accum_dtype`` is the
    reference's accumulator rule (None: the payload's).  CPU tensors take
    the plain version; CUDA tensors the kernel."""
    global launches
    name = "block_spmv"
    cuda = backend.on_cuda(name, indices=indices, data=data, x=x_blocks)
    nbr, kmax, br, bc = data.shape
    threads = autotune.launch_threads(
        name, autotune.signature(data.dtype, nbr, br=br, bc=bc, kmax=kmax),
        threads, data.device)
    lanes = ell_rows.lanes(br, bc, kmax)
    if not cuda:
        return block_spmv_ell_ref(indices, data, x_blocks,
                                  accum_dtype=accum_dtype)
    if (br, bc) not in SHAPES:
        raise ValueError(f"{name}: block shape {(br, bc)} has no kernel "
                         f"instantiation (have {SHAPES})")
    if tuple(indices.shape) != (nbr, kmax) or x_blocks.shape[1] != bc:
        raise ValueError(f"{name}: shapes {tuple(indices.shape)}, "
                         f"{tuple(data.shape)}, {tuple(x_blocks.shape)} "
                         f"disagree")
    backend.check_kernel_args(name, dict(data=data, x=x_blocks),
                              dict(indices=indices))
    ell_rows.check_payload(name, data)
    y = launch_lanes(indices, data, x_blocks, lanes, threads, accum_dtype)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[data.dtype]] += 1
    launches_by_shape[(br, bc)] += 1
    return y


def launch_lanes(indices: torch.Tensor, data: torch.Tensor,
                 x_blocks: torch.Tensor, lanes: int, threads: int,
                 accum_dtype=None) -> torch.Tensor:
    """The kernel at an explicit ``lanes`` (the wrapper passes
    ``ell_rows.lanes``; the card tests and ``chip_smoke.py`` sweep it).
    Takes checked CUDA tensors, counts no launch; the C entry point
    refuses a ``lanes`` that is not a power of two <= 32."""
    nbr, kmax, br, bc = data.shape
    y = torch.empty((nbr, br), dtype=data.dtype, device=data.device)
    fn = backend.entry("block_spmv", data.dtype, accum_dtype)
    backend.launch(fn, _ARGS, backend.ptr(indices), backend.ptr(data),
                   backend.ptr(x_blocks), backend.ptr(y), nbr, kmax, br, bc,
                   lanes, threads)
    return y


def block_spmv(ell: BlockELL, x: torch.Tensor, *,
               threads: int | None = None, accum_dtype=None) -> torch.Tensor:
    """y = A x on flat vectors: ``(nbc*bc,)`` -> ``(nbr*br,)``."""
    y = block_spmv_ell(ell.indices, ell.data, x.reshape(ell.nbc, ell.bc),
                       threads=threads, accum_dtype=accum_dtype)
    return y.reshape(ell.nbr * ell.br)
