"""Wrapper of the sorted block segment sum (``csrc/block_seg_sum.cu``).

Serves the COO reassembly (``core.block_coo.set_values_coo``, reading the
value stream through the plan's composed permutation) and the SpGEMM
row-split combine (``core.spgemm``, identity order).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.block_seg_sum.ref import block_seg_sum_ref

SHAPES = ((3, 3), (3, 6), (6, 6))
_ARGS = (backend.P,) * 4 + (backend.I,) * 3 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0


def block_seg_sum(vals: torch.Tensor, offsets: torch.Tensor,
                  perm: torch.Tensor | None = None) -> torch.Tensor:
    """Sum the ``(n, br, bc)`` block stream into ``(len(offsets)-1, br, bc)``
    segments: segment ``s`` is positions ``offsets[s]:offsets[s+1]`` of the
    stream, read through ``perm`` when given.  ``offsets`` and ``perm`` are
    int32.  CPU tensors take the plain version; CUDA tensors the kernel."""
    global launches
    name = "block_seg_sum"
    if not backend.on_cuda(name, vals=vals, offsets=offsets, perm=perm):
        return block_seg_sum_ref(vals, offsets, perm)
    if vals.ndim != 3 or tuple(vals.shape[1:]) not in SHAPES:
        raise ValueError(f"{name}: block shape {tuple(vals.shape[1:])} has "
                         f"no kernel instantiation (have {SHAPES})")
    backend.check_kernel_args(name, dict(vals=vals),
                              dict(offsets=offsets, perm=perm))
    nseg = offsets.shape[0] - 1
    br, bc = vals.shape[1], vals.shape[2]
    out = torch.empty((nseg, br, bc), dtype=vals.dtype, device=vals.device)
    backend.launch("repro_block_seg_sum_f64", _ARGS, backend.ptr(vals),
                   backend.ptr(perm), backend.ptr(offsets), backend.ptr(out),
                   nseg, br, bc)
    launches += 1
    return out
