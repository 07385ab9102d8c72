"""Wrapper of the sorted block segment sum (``csrc/block_seg_sum.cu``).

Serves the COO reassembly (``core.block_coo.set_values_coo``, reading the
value stream through the plan's composed permutation) and the SpGEMM
row-split combine (``core.spgemm``, identity order).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref
from repro_torch.obs import trace as obs_trace

SHAPES = ((3, 3), (3, 6), (6, 6))
_ARGS = (backend.P,) * 4 + (backend.I,) * 3 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)


@obs_trace.spanned("kernels/block_seg_sum")
def block_seg_sum(vals: torch.Tensor, offsets: torch.Tensor,
                  perm: torch.Tensor | None = None, *,
                  accum_dtype=None) -> torch.Tensor:
    """Sum the ``(n, br, bc)`` block stream into ``(len(offsets)-1, br, bc)``
    segments: segment ``s`` is positions ``offsets[s]:offsets[s+1]`` of the
    stream, read through ``perm`` when given.  ``offsets`` and ``perm`` are
    int32.  Payloads f64, f32 or bf16, summed at ``accum_dtype`` (None:
    the payload's) and rounded once; a bf16 stream is summed at an f32
    accumulator, which it must name.  CPU tensors take the plain version;
    CUDA tensors the kernel."""
    global launches
    name = "block_seg_sum"
    if vals.dtype == torch.bfloat16 and \
            backend.accumulator(vals.dtype, accum_dtype) != torch.float32:
        raise ValueError(f"{name}: a bf16 stream is summed at an f32 "
                         f"accumulator: pass accum_dtype=torch.float32")
    if not backend.on_cuda(name, vals=vals, offsets=offsets, perm=perm):
        return block_seg_sum_ref(vals, offsets, perm,
                                 accum_dtype=accum_dtype)
    if vals.ndim != 3 or tuple(vals.shape[1:]) not in SHAPES:
        raise ValueError(f"{name}: block shape {tuple(vals.shape[1:])} has "
                         f"no kernel instantiation (have {SHAPES})")
    backend.check_kernel_args(name, dict(vals=vals),
                              dict(offsets=offsets, perm=perm))
    nseg = offsets.shape[0] - 1
    br, bc = vals.shape[1], vals.shape[2]
    out = torch.empty((nseg, br, bc), dtype=vals.dtype, device=vals.device)
    backend.launch(backend.entry(name, vals.dtype, accum_dtype), _ARGS,
                   backend.ptr(vals), backend.ptr(perm), backend.ptr(offsets),
                   backend.ptr(out), nseg, br, bc)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[vals.dtype]] += 1
    return out
