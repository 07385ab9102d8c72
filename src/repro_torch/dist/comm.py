"""Rank communication over a ``torch.distributed`` process group.

The reference runs its distributed hot path as one ``shard_map`` program
whose collectives are ``lax.ppermute``, ``lax.psum`` and
``lax.all_gather(tiled=True)``.  Here one process is one rank, and
``RankComm`` is what those become:

``exchange(slab, perm)``   one ``ppermute``: the ``(src, dst)`` pairs of
                           ``perm`` as isend/irecv pairs, returned in
                           flight; ``Exchange.wait()`` gives the slab this
                           rank received, zeros where ``perm`` names no
                           source for it (an edge rank).
``all_gather_tiled(x)``    the per-rank slabs concatenated in rank order.
``all_gather(x)``          the per-rank tensors stacked in rank order.
``allreduce_sum(x)``       ``psum``, deterministically: the partials are
                           gathered and summed in rank order, so every rank
                           holds the same bits whatever the backend, and a
                           branch on a reduced value (CG's exit test, the
                           health flags) takes the same way on every rank.

Backends.  The caller picks the backend when it creates the process group;
nothing here guesses.  ``"nccl"`` moves CUDA tensors and a CPU tensor
raises.  ``"gloo"`` moves CPU tensors; given CUDA tensors it stages every
payload of every call through host memory (a device-to-host copy before
the call, a host-to-device copy after), one rule for all calls, and counts
those bytes in ``staged_bytes``.  That is how several rank processes share
one card, where NCCL refuses two ranks on one device.

Counters (``counts()``, zeroed by ``reset()``), kept as the reference's
``repro.dist.measure`` counts a jaxpr's collectives so that
``repro_torch.dist.measure`` can hold them against
``repro_torch.obs.model.dist_cycle_comm``: one ``exchange`` is one
ppermute and one slab message of ``slab.nbytes`` (whether or not this rank
has a neighbour on that side), one ``all_gather_tiled`` is ``world - 1``
slab messages.  Reductions are counted apart (``allreduce``); the comm
model charges none.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

BACKENDS = ("nccl", "gloo")

#: the flat all-gather (its newer name where the installed torch has it)
_gather_into = getattr(tdist, "all_gather_single", None) \
    or tdist.all_gather_into_tensor


class Exchange:
    """An in-flight ppermute: ``wait()`` returns the received slab on the
    slab's device (zeros when this rank receives nothing)."""

    def __init__(self, comm: "RankComm", like: torch.Tensor, works: list,
                 recv: torch.Tensor | None, keep: tuple):
        self._comm, self._like = comm, like
        self._works, self._recv = works, recv
        self._keep = keep          # send buffers stay alive until wait

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        self._keep = ()
        if self._recv is None:
            return torch.zeros_like(self._like)
        return self._comm._back(self._recv, self._like)


class RankComm:
    """This process's view of a process group (``group=None``: the default
    one, which the caller has initialised)."""

    def __init__(self, group=None):
        if not (tdist.is_available() and tdist.is_initialized()):
            raise RuntimeError(
                "RankComm needs an initialised torch.distributed process "
                "group (init_process_group with the backend, world size "
                "and rank)")
        self.group = group
        self.rank = tdist.get_rank(group)
        self.world = tdist.get_world_size(group)
        self.backend = str(tdist.get_backend(group)).lower()
        if self.backend not in BACKENDS:
            raise ValueError(f"unsupported backend {self.backend!r}: "
                             f"expected one of {BACKENDS}")
        self.reset()

    # ---- counters ------------------------------------------------------
    def reset(self) -> None:
        self.ppermutes = self.all_gathers = self.allreduces = 0
        self.msgs = self.bytes = self.staged_bytes = 0

    def counts(self) -> dict:
        return dict(ppermute=self.ppermutes, all_gather=self.all_gathers,
                    msgs=self.msgs, bytes=self.bytes,
                    allreduce=self.allreduces,
                    staged_bytes=self.staged_bytes)

    # ---- staging -------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend moves it: contiguous, on the host for gloo
        (counted), on the card for nccl (a CPU tensor raises)."""
        if t.device.type == "cpu":
            if self.backend == "nccl":
                raise ValueError(
                    "the nccl backend moves CUDA tensors; CPU tensors "
                    "take the gloo backend")
            return t.contiguous()
        if self.backend == "gloo":
            self.staged_bytes += t.numel() * t.element_size()
            return t.detach().to("cpu").contiguous()
        return t.contiguous()

    def _buffer(self, like: torch.Tensor, shape=None) -> torch.Tensor:
        dev = "cpu" if self.backend == "gloo" else like.device
        return torch.empty(like.shape if shape is None else shape,
                           dtype=like.dtype, device=dev)

    def _back(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if t.device == like.device:
            return t
        self.staged_bytes += t.numel() * t.element_size()
        return t.to(like.device)

    # ---- collectives ---------------------------------------------------
    def exchange(self, slab: torch.Tensor, perm) -> Exchange:
        """Start one ppermute of ``slab`` over the ``(src, dst)`` pairs of
        ``perm``."""
        self.ppermutes += 1
        self.msgs += 1
        self.bytes += slab.numel() * slab.element_size()
        sends = [dst for src, dst in perm if src == self.rank]
        srcs = [src for src, dst in perm if dst == self.rank]
        if len(sends) > 1 or len(srcs) > 1:
            raise ValueError(f"perm {perm} is not a permutation")
        wire = self._wire(slab) if sends else None
        recv = self._buffer(slab) if srcs else None
        ops = []
        if sends:
            ops.append(tdist.P2POp(tdist.isend, wire, sends[0], self.group))
        if srcs:
            ops.append(tdist.P2POp(tdist.irecv, recv, srcs[0], self.group))
        works = tdist.batch_isend_irecv(ops) if ops else []
        return Exchange(self, slab, works, recv, (wire,))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(world,) + x.shape``: every rank's ``x`` in rank order (not
        counted; the building block of the counted collectives)."""
        wire = self._wire(x).reshape(1, -1)
        out = self._buffer(x, (self.world, wire.shape[1]))
        _gather_into(out, wire, group=self.group)
        return self._back(out, x).reshape((self.world,) + tuple(x.shape))

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_gather(x, tiled=True)``: ``(world * x.shape[0], ...)``,
        rank 0's slab first."""
        self.all_gathers += 1
        self.msgs += self.world - 1
        self.bytes += (self.world - 1) * x.numel() * x.element_size()
        g = self.all_gather(x)
        return g.reshape((self.world * x.shape[0],) + tuple(x.shape[1:]))

    def allreduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``: the sum of every rank's ``x``, added in rank order
        (the same bits on every rank)."""
        self.allreduces += 1
        parts = self.all_gather(x)
        out = parts[0]
        for r in range(1, self.world):
            out = out + parts[r]
        return out
