"""Wrapper of the fused pbjacobi update kernel (``csrc/pbjacobi.cu``).

As in the reference, the kernel autotuner (``repro_torch.kernels.
autotune``) is the only caller of ``pbjacobi_apply``: the solver's
pbjacobi smoother applies ``D^-1`` inside ``fused_smoother``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune, backend
from repro_torch.kernels.pbjacobi.ref import pbjacobi_update_ref

SHAPES = (3, 6)
_ARGS = (backend.P,) * 4 + (backend.D,) + (backend.P,) + (backend.I,) * 3 \
    + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)


def pbjacobi_update(dinv: torch.Tensor, r_blocks: torch.Tensor,
                    x_blocks: torch.Tensor, omega, *,
                    threads: int | None = None,
                    accum_dtype=None) -> torch.Tensor:
    """``x + omega * D^-1 r`` over ``(nbr, bs)`` block vectors, ``dinv``
    ``(nbr, bs, bs)``; ``omega`` a number (passed to the kernel by value)
    or a one-element tensor on the operands' device (read there, so no
    launch waits on the host), rounded to the accumulator in the kernel.
    Payloads f64, f32 or bf16; ``accum_dtype`` is the reference's
    accumulator rule (None: the payload's; a bf16 payload also takes an
    f32 accumulator).
    ``threads=None`` resolves through the autotuner (static default 256).
    CPU tensors take the plain version; CUDA tensors the kernel."""
    global launches
    name = "pbjacobi"
    w = omega if isinstance(omega, torch.Tensor) else None
    cuda = backend.on_cuda(name, dinv=dinv, r=r_blocks, x=x_blocks, omega=w)
    nbr, bs = dinv.shape[0], dinv.shape[1]
    threads = autotune.launch_threads(
        name, autotune.signature(dinv.dtype, nbr * bs, bs=bs), threads,
        dinv.device)
    if not cuda:
        return pbjacobi_update_ref(dinv, r_blocks, x_blocks, omega,
                                   accum_dtype=accum_dtype)
    if bs not in SHAPES or tuple(dinv.shape) != (nbr, bs, bs) \
            or tuple(r_blocks.shape) != (nbr, bs) \
            or tuple(x_blocks.shape) != (nbr, bs):
        raise ValueError(f"{name}: shapes {tuple(dinv.shape)}, "
                         f"{tuple(r_blocks.shape)}, {tuple(x_blocks.shape)} "
                         f"disagree or have no kernel instantiation (bs in "
                         f"{SHAPES})")
    if w is not None:
        if w.numel() != 1:
            raise ValueError(f"{name}: omega must hold one value, got "
                             f"shape {tuple(w.shape)}")
        w = w.reshape(1)
    backend.check_kernel_args(name, dict(dinv=dinv, r=r_blocks, x=x_blocks,
                                         omega=w))
    out = torch.empty_like(x_blocks)
    p = backend.ptr
    fn = backend.entry(name, dinv.dtype, accum_dtype, bf16_f32=True)
    backend.launch(fn, _ARGS, p(dinv), p(r_blocks), p(x_blocks), p(w),
                   0.0 if w is not None else float(omega), p(out), nbr, bs,
                   threads)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[dinv.dtype]] += 1
    return out


def pbjacobi_apply(dinv: torch.Tensor, r: torch.Tensor, x: torch.Tensor,
                   omega, *, threads: int | None = None,
                   accum_dtype=None) -> torch.Tensor:
    """Flat-vector front door: ``x``, ``r`` are ``(nbr*bs,)``;
    ``accum_dtype`` as in ``pbjacobi_update``."""
    nbr, bs = dinv.shape[0], dinv.shape[1]
    out = pbjacobi_update(dinv, r.reshape(nbr, bs), x.reshape(nbr, bs),
                          omega, threads=threads, accum_dtype=accum_dtype)
    return out.reshape(-1)
