"""Host-to-device bytes of a call, counted at the aten level.

``count_h2d(fn)`` runs ``fn`` under a dispatch mode and adds up every
aten copy (``_to_copy``, ``copy_``) whose source is a CPU tensor and
whose result lies on the card.  The kernel library copies nothing
itself, so every transfer that the port's Python makes through a torch
copy is counted.  A copy made inside another op's C++ body is not seen:
``torch.tensor(list, device="cuda")`` builds on the host and copies with
dispatch modes off, and indexing a CUDA tensor with a CPU index tensor
moves the index inside ``aten::index``.  ``chip_smoke.py`` therefore
holds this count beside the profiler's memcpy records of the same calls,
with a control of each kind.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_COPIES = (torch.ops.aten._to_copy, torch.ops.aten.copy_)


class HostToDeviceCopies(TorchDispatchMode):
    """Inside the block, ``nbytes`` and ``count`` of the aten copies from a
    CPU tensor to the card."""

    def __init__(self):
        super().__init__()
        self.nbytes = self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _COPIES and any(
                isinstance(t, torch.Tensor) and t.is_cuda
                for t in tree_leaves(out)):
            src = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor) and t.device.type == "cpu"]
            if src:
                self.nbytes += sum(t.numel() * t.element_size() for t in src)
                self.count += 1
        return out


def count_h2d(fn):
    """``fn()``'s result, and the bytes and number of its aten copies from
    the host to the card."""
    with HostToDeviceCopies() as mode:
        out = fn()
    return out, mode.nbytes, mode.count
