"""Wrapper of the batched block GEMM kernel (``csrc/block_pair_gemm.cu``).

``repro_torch.core.spgemm`` runs the pair products of the unfused "pairs"
numeric path through here (gather, this kernel, then ``block_seg_sum``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.block_pair_gemm.ref import block_pair_gemm_ref
from repro_torch.obs import trace as obs_trace

SHAPES = ((3, 3, 6), (6, 3, 6), (6, 6, 6))
_ARGS = (backend.P,) * 3 + (backend.I,) * 4 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)


@obs_trace.spanned("kernels/block_pair_gemm")
def block_pair_gemm(lhs: torch.Tensor, rhs: torch.Tensor, *,
                    accum_dtype=None, out_dtype=None) -> torch.Tensor:
    """``(npairs, br, bk) @ (npairs, bk, bc)`` -> ``(npairs, br, bc)``.
    Payloads f64, f32 or bf16, contracted at ``accum_dtype`` (the
    reference's rule; None: the payload's) and rounded once to
    ``out_dtype``: the payload dtype (None), or for bf16 operands with an
    f32 accumulator, f32 — the pairs path keeps its products at the
    accumulator until they are combined.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    global launches
    name = "block_pair_gemm"
    if lhs.ndim != 3 or rhs.ndim != 3 or lhs.shape[0] != rhs.shape[0] \
            or lhs.shape[2] != rhs.shape[1]:
        raise ValueError(f"{name}: shapes {tuple(lhs.shape)} @ "
                         f"{tuple(rhs.shape)} disagree")
    if not backend.on_cuda(name, lhs=lhs, rhs=rhs):
        return block_pair_gemm_ref(lhs, rhs, accum_dtype=accum_dtype,
                                   out_dtype=out_dtype)
    npairs, br, bk = lhs.shape
    bc = rhs.shape[2]
    if (br, bk, bc) not in SHAPES:
        raise ValueError(f"{name}: block shapes {(br, bk)} @ {(bk, bc)} "
                         f"have no kernel instantiation (have {SHAPES})")
    backend.check_kernel_args(name, dict(lhs=lhs, rhs=rhs))
    fn = backend.entry(name, lhs.dtype, accum_dtype)
    out_dtype = lhs.dtype if out_dtype is None else out_dtype
    if out_dtype != lhs.dtype:
        if not (lhs.dtype == torch.bfloat16 and out_dtype == torch.float32
                and backend.accumulator(lhs.dtype, accum_dtype)
                == torch.float32):
            raise ValueError(f"{name}: no kernel instantiation writes "
                             f"{out_dtype} products of {lhs.dtype} operands "
                             f"at accum_dtype={accum_dtype!r}")
        fn = f"repro_{name}_bf16_f32"
    out = torch.empty((npairs, br, bc), dtype=out_dtype, device=lhs.device)
    backend.launch(fn, _ARGS, backend.ptr(lhs), backend.ptr(rhs),
                   backend.ptr(out), npairs, br, bk, bc)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[lhs.dtype]] += 1
    return out
