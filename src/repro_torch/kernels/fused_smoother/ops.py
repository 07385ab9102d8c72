"""Wrapper of the fused smoother step kernel (``csrc/fused_smoother.cu``).

``repro_torch.core.vcycle.apply_smoother`` dispatches here on the fused
smoother path (the default), for vectors and for the multi-RHS solve's
``(n, k)`` panels (one entry point each in the CUDA source).
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL
from repro_torch.kernels import autotune, backend, ell_rows
from repro_torch.kernels.fused_smoother.ref import smoother_step_ref
from repro_torch.obs import trace as obs_trace

SHAPES = (3, 6)
_ARGS = (backend.P,) * 9 + (backend.I,) * 5 + (backend.P,)
_PANEL_ARGS = (backend.P,) * 9 + (backend.I,) * 6 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)


@obs_trace.spanned("kernels/fused_smoother")
def smoother_step_ell(indices: torch.Tensor, data: torch.Tensor,
                      dinv: torch.Tensor, b_blocks: torch.Tensor,
                      x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                      coef: torch.Tensor, *, threads: int | None = None,
                      accum_dtype=None):
    """``(x', d')`` for one fused step over ``(nbr, bs)`` block vectors or
    ``(nbr, bs, k)`` panels; A square in padded BlockELL form, ``dinv
    (nbr, bs, bs)``, ``coef`` a two-element device tensor ``[c1, c2]``
    shared by all columns.  ``x'`` is a new tensor (out of place).  Each
    block row takes ``ell_rows.lanes(bs, bs, kmax)`` lanes, as in
    ``block_spmv``, so the step's ``A x`` is bitwise ``block_spmv``'s and a
    panel column bitwise the vector step; ``threads`` per CUDA block,
    ``None`` resolved through the autotuner (static default 256; a panel's
    signature has its k), only sets how many rows share a block.
    Payloads f64, f32 or bf16 (``coef`` at the payload dtype too);
    ``accum_dtype`` is the reference's accumulator rule (None: the
    payload's; a bf16 payload also takes an f32 accumulator).  CPU tensors
    take the plain version; CUDA tensors the kernel."""
    global launches
    name = "fused_smoother"
    cuda = backend.on_cuda(name, indices=indices, data=data, dinv=dinv,
                           b=b_blocks, x=x_blocks, d=d_blocks, coef=coef)
    nbr, kmax, bs, bs2 = data.shape
    keys = dict(br=bs, bc=bs2, kmax=kmax)
    if b_blocks.ndim == 3:
        keys["k"] = b_blocks.shape[2]
    threads = autotune.launch_threads(
        name, autotune.signature(data.dtype, nbr * keys.get("k", 1),
                                 **keys), threads, data.device)
    lanes = ell_rows.lanes(bs, bs2, kmax)
    if not cuda:
        return smoother_step_ref(indices, data, dinv, b_blocks, x_blocks,
                                 d_blocks, coef, accum_dtype=accum_dtype)
    if bs != bs2 or bs not in SHAPES:
        raise ValueError(f"{name}: block shape {(bs, bs2)} has no kernel "
                         f"instantiation (square, bs in {SHAPES})")
    vec = tuple(b_blocks.shape)
    if (len(vec) not in (2, 3) or vec[:2] != (nbr, bs)
            or (len(vec) == 3 and vec[2] <= 0)
            or tuple(indices.shape) != (nbr, kmax)
            or tuple(dinv.shape) != (nbr, bs, bs)
            or any(tuple(v.shape) != vec for v in (b_blocks, x_blocks,
                                                    d_blocks))
            or tuple(coef.shape) != (2,)):
        raise ValueError(f"{name}: operand shapes disagree with A "
                         f"{tuple(data.shape)}")
    backend.check_kernel_args(
        name, dict(data=data, dinv=dinv, b=b_blocks, x=x_blocks, d=d_blocks,
                   coef=coef), dict(indices=indices))
    ell_rows.check_payload(name, data)
    out = launch_lanes(indices, data, dinv, b_blocks, x_blocks, d_blocks,
                       coef, lanes, threads, accum_dtype)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[data.dtype]] += 1
    return out


def launch_lanes(indices: torch.Tensor, data: torch.Tensor,
                 dinv: torch.Tensor, b_blocks: torch.Tensor,
                 x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                 coef: torch.Tensor, lanes: int, threads: int,
                 accum_dtype=None):
    """``(x', d')`` from the kernel at an explicit ``lanes`` (the wrapper
    passes ``ell_rows.lanes``; the card tests and ``chip_smoke.py`` sweep
    it).  Takes checked CUDA tensors, counts no launch; the C entry points
    refuse a ``lanes`` that is not a power of two <= 32."""
    nbr, kmax, bs, _ = data.shape
    vec = tuple(b_blocks.shape)
    x_new = torch.empty(vec, dtype=data.dtype, device=data.device)
    d_new = torch.empty(vec, dtype=data.dtype, device=data.device)
    p = backend.ptr
    ptrs = (p(indices), p(data), p(dinv), p(b_blocks), p(x_blocks),
            p(d_blocks), p(coef), p(x_new), p(d_new))
    name = "fused_smoother" if len(vec) == 2 else "fused_smoother_panel"
    fn = backend.entry(name, data.dtype, accum_dtype, bf16_f32=True)
    if len(vec) == 2:
        backend.launch(fn, _ARGS, *ptrs, nbr, kmax, bs, lanes, threads)
    else:
        backend.launch(fn, _PANEL_ARGS, *ptrs, nbr, kmax, bs, vec[2], lanes,
                       threads)
    return x_new, d_new


def smoother_step(a_ell: BlockELL, dinv: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor, d: torch.Tensor, coef: torch.Tensor, *,
                  threads: int | None = None, accum_dtype=None):
    """The fused step on flat ``(n,)`` vectors or ``(n, k)`` panels;
    returns ``(x', d')``."""
    shape = (a_ell.nbr, a_ell.br) + tuple(b.shape[1:])
    x_new, d_new = smoother_step_ell(a_ell.indices, a_ell.data, dinv,
                                     b.reshape(shape), x.reshape(shape),
                                     d.reshape(shape), coef, threads=threads,
                                     accum_dtype=accum_dtype)
    return x_new.reshape(b.shape), d_new.reshape(b.shape)
