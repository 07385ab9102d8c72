"""Wrapper of the blocked ELL SpMM kernel (``csrc/block_spmm.cu``).

Every panel operator product of the multi-RHS solve runs through here
(``repro_torch.core.spmv.spmm_ell``): CG's ``A P``, the V-cycle residual
and prolongation on ``(n, k)`` panels.  ``k`` is a runtime argument of
the kernel; nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL
from repro_torch.kernels import autotune, backend, ell_rows
from repro_torch.kernels.block_spmm.ref import block_spmm_ell_ref
from repro_torch.obs import trace as obs_trace

SHAPES = ((3, 3), (3, 6), (6, 3), (6, 6))
_ARGS = (backend.P,) * 4 + (backend.I,) * 7 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)
#: the same launches by block shape ``(br, bc)``
launches_by_shape = dict.fromkeys(SHAPES, 0)


@obs_trace.spanned("kernels/block_spmm")
def block_spmm_ell(indices: torch.Tensor, data: torch.Tensor,
                   x_panels: torch.Tensor, *, threads: int | None = None,
                   accum_dtype=None) -> torch.Tensor:
    """Y = A X with A in padded BlockELL form: int32 ``(nbr, kmax)``
    indices, ``(nbr, kmax, br, bc)`` data, ``(nbc, bc, k)`` X -> ``(nbr,
    br, k)``.  Each block row takes ``ell_rows.lanes(br, bc, kmax)`` lanes,
    as in ``block_spmv``, so column j is bitwise ``block_spmv`` of column
    j; ``threads`` per CUDA block, ``None`` resolved through the autotuner
    (static default 256), only sets how many rows share a block.
    Payloads and ``accum_dtype`` as in ``block_spmv``.  CPU tensors take
    the plain version; CUDA tensors the kernel."""
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
    lanes = ell_rows.lanes(br, bc, kmax)
    if not cuda:
        return block_spmm_ell_ref(indices, data, x_panels,
                                  accum_dtype=accum_dtype)
    if (br, bc) not in SHAPES:
        raise ValueError(f"{name}: block shape {(br, bc)} has no kernel "
                         f"instantiation (have {SHAPES})")
    if tuple(indices.shape) != (nbr, kmax) or x_panels.shape[1] != bc:
        raise ValueError(f"{name}: shapes {tuple(indices.shape)}, "
                         f"{tuple(data.shape)}, {tuple(x_panels.shape)} "
                         f"disagree")
    backend.check_kernel_args(name, dict(data=data, x=x_panels),
                              dict(indices=indices))
    ell_rows.check_payload(name, data)
    y = launch_lanes(indices, data, x_panels, lanes, threads, accum_dtype)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[data.dtype]] += 1
    launches_by_shape[(br, bc)] += 1
    return y


def launch_lanes(indices: torch.Tensor, data: torch.Tensor,
                 x_panels: torch.Tensor, lanes: int, threads: int,
                 accum_dtype=None) -> torch.Tensor:
    """The kernel at an explicit ``lanes`` (the wrapper passes
    ``ell_rows.lanes``; the card tests and ``chip_smoke.py`` sweep it).
    Takes checked CUDA tensors, counts no launch; the C entry point
    refuses a ``lanes`` that is not a power of two <= 32."""
    nbr, kmax, br, bc = data.shape
    k = x_panels.shape[2]
    y = torch.empty((nbr, br, k), dtype=data.dtype, device=data.device)
    fn = backend.entry("block_spmm", data.dtype, accum_dtype)
    backend.launch(fn, _ARGS, backend.ptr(indices), backend.ptr(data),
                   backend.ptr(x_panels), backend.ptr(y), nbr, kmax, br, bc,
                   k, lanes, threads)
    return y


def block_spmm(ell: BlockELL, X: torch.Tensor, *,
               threads: int | None = None, accum_dtype=None) -> torch.Tensor:
    """Y = A X on flat panels: ``(nbc*bc, k)`` -> ``(nbr*br, k)``."""
    k = X.shape[1]
    y = block_spmm_ell(ell.indices, ell.data, X.reshape(ell.nbc, ell.bc, k),
                       threads=threads, accum_dtype=accum_dtype)
    return y.reshape(ell.nbr * ell.br, k)
