"""Plain PyTorch version of the sorted block segment sum."""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import accumulator


def block_seg_sum_ref(vals: torch.Tensor, offsets: torch.Tensor,
                      perm: torch.Tensor | None = None, *,
                      accum_dtype=None) -> torch.Tensor:
    """``out[s] = sum(vals[src(j)] for j in range(offsets[s],
    offsets[s+1]))`` with ``src(j) = perm[j]`` (or ``j`` without ``perm``),
    at ``vals.dtype``.

    Sums each segment in stream order starting from zero — the order of a
    sorted ``segment_sum`` — one gather per position within the segments,
    at ``accum_dtype`` (None: ``vals.dtype``), rounded once.  Empty
    segments give zero blocks.
    """
    acc = accumulator(vals.dtype, accum_dtype)
    offsets = offsets.long()
    starts = offsets[:-1]
    counts = offsets[1:] - starts
    nseg = starts.shape[0]
    out = torch.zeros((nseg,) + tuple(vals.shape[1:]), dtype=acc,
                      device=vals.device)
    n = perm.shape[0] if perm is not None else vals.shape[0]
    if nseg == 0 or n == 0:
        return out.to(vals.dtype)
    src_of = perm.long() if perm is not None else None
    zero = torch.zeros((), dtype=acc, device=vals.device)
    for k in range(int(counts.max())):
        j = (starts + k).clamp(max=n - 1)
        src = src_of[j] if src_of is not None else j
        out = out + torch.where((counts > k)[:, None, None],
                                vals[src].to(acc), zero)
    return out.to(vals.dtype)
