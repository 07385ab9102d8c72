"""Wrapper of the fused tiled pair-GEMM kernel (``csrc/fused_pair_gemm.cu``).

``repro_torch.core.spgemm`` runs both Galerkin products of every PtAP and
the setup's ``(D^-1 A) P~`` through here on the fused SpGEMM path, and
at ``(1, 1, 1)`` the scalar (AIJ) baseline's PtAP chain
(``core.scalar_path.build_scalar_ptap_chain``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune, backend
from repro_torch.kernels.fused_pair_gemm.ref import fused_pair_gemm_ref
from repro_torch.obs import trace as obs_trace

SHAPES = ((3, 3, 6), (6, 3, 6), (6, 6, 6), (1, 1, 1))
_ARGS = (backend.P,) * 6 + (backend.I,) * 6 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)
#: the same launches by block shapes ``(br, bk, bc)``
launches_by_shape = dict.fromkeys(SHAPES, 0)


@obs_trace.spanned("kernels/fused_pair_gemm")
def fused_pair_gemm(a_data: torch.Tensor, b_data: torch.Tensor,
                    tile_a: torch.Tensor, tile_b: torch.Tensor,
                    tile_mask: torch.Tensor, *, threads: int | None = None,
                    accum_dtype=None) -> torch.Tensor:
    """One partial ``(br, bc)`` block per tile row: the sum over the row's
    valid slots of ``a_data[tile_a] @ b_data[tile_b]``, gathered in the
    kernel.  ``tile_a``/``tile_b`` int32 ``(rows, kmax)``, ``tile_mask``
    bool.  ``threads`` per CTA (one per output row of a tile row's block;
    the CTA stages its rows' blocks in shared memory) ``None`` resolves
    through the autotuner (static default 256); every value gives the same
    bits.  Payloads f64, f32 or bf16, contracted at ``accum_dtype`` (the
    reference's rule; None: the payload's, bf16 summing at f32) and
    rounded once to the payload dtype.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    global launches
    name = "fused_pair_gemm"
    cuda = backend.on_cuda(name, a=a_data, b=b_data, tile_a=tile_a,
                           tile_b=tile_b, tile_mask=tile_mask)
    _, br, bk = a_data.shape
    _, bk2, bc = b_data.shape
    rows, kmax = tile_a.shape
    threads = autotune.launch_threads(
        name, autotune.signature(a_data.dtype, rows * br * bc, br=br, bk=bk,
                                 bc=bc, kmax=kmax), threads, a_data.device)
    if not cuda:
        return fused_pair_gemm_ref(a_data, b_data, tile_a, tile_b, tile_mask,
                                   accum_dtype=accum_dtype)
    if bk != bk2 or (br, bk, bc) not in SHAPES:
        raise ValueError(f"{name}: block shapes {(br, bk)} @ {(bk2, bc)} "
                         f"have no kernel instantiation (have {SHAPES})")
    if tuple(tile_b.shape) != (rows, kmax) or \
            tuple(tile_mask.shape) != (rows, kmax):
        raise ValueError(f"{name}: tile plan shapes disagree")
    backend.check_kernel_args(name, dict(a=a_data, b=b_data),
                              dict(tile_a=tile_a, tile_b=tile_b),
                              dict(tile_mask=tile_mask))
    out = torch.empty((rows, br, bc), dtype=a_data.dtype,
                      device=a_data.device)
    p = backend.ptr
    backend.launch(backend.entry(name, a_data.dtype, accum_dtype), _ARGS,
                   p(a_data), p(b_data), p(tile_a), p(tile_b), p(tile_mask),
                   p(out), rows, kmax, br, bk, bc, threads)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[a_data.dtype]] += 1
    launches_by_shape[(br, bk, bc)] += 1
    return out
