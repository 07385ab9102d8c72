"""Wrapper of the fused smoother step kernel (``csrc/fused_smoother.cu``).

``repro_torch.core.vcycle.apply_smoother`` dispatches here on the fused
smoother path (the default), for vectors and for the multi-RHS solve's
``(n, k)`` panels (one entry point each in the CUDA source), and on the
scalar (AIJ) baseline's levels (``core.scalar_path``: A in 1x1 ELL rows,
``D^-1`` in node blocks) to the scalar-row entry point, vectors only.
"""
from __future__ import annotations

import torch

from repro_torch.core.block_csr import BlockELL
from repro_torch.kernels import autotune, backend, ell_rows
from repro_torch.kernels.fused_smoother.ref import smoother_step_ref, \
    smoother_step_scalar_ref
from repro_torch.obs import trace as obs_trace

SHAPES = (3, 6)
_ARGS = (backend.P,) * 9 + (backend.I,) * 5 + (backend.P,)
_PANEL_ARGS = (backend.P,) * 10 + (backend.I,) * 6 + (backend.P,)

#: kernel launches since the last reset (plain-version calls do not count)
launches = 0
#: the same launches by payload dtype ("f64", "f32", "bf16")
launches_by_dtype = dict.fromkeys(backend.PAYLOADS.values(), 0)
#: the same launches by ``(a_ell block rows, dinv block)``: ``(bs, bs)``
#: for the blocked step, ``(1, bs)`` for the scalar-row step
launches_by_shape = dict.fromkeys(
    [(bs, bs) for bs in SHAPES] + [(1, bs) for bs in SHAPES], 0)
#: the same launches by the kernel body that ran them: "staged" for 6x6
#: panels (k > 1, the rule of ``launch()`` in ``csrc/fused_smoother.cu``),
#: "sub_warp" for every other blocked launch and the scalar-row step
launches_by_body = {"sub_warp": 0, "staged": 0}


@obs_trace.spanned("kernels/fused_smoother")
def smoother_step_ell(indices: torch.Tensor, data: torch.Tensor,
                      dinv: torch.Tensor, b_blocks: torch.Tensor,
                      x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                      coef: torch.Tensor, *, threads: int | None = None,
                      accum_dtype=None, lengths: torch.Tensor | None = None):
    """``(x', d')`` for one fused step over ``(nbr, bs)`` block vectors or
    ``(nbr, bs, k)`` panels; A square in padded BlockELL form, ``dinv
    (nbr, bs, bs)``, ``coef`` a two-element device tensor ``[c1, c2]``
    shared by all columns.  ``x'`` is a new tensor (out of place).
    ``lengths`` (int32 ``(nbr,)``, the ELL's valid slots a row; None:
    every row runs to ``kmax``) goes to the panel entry, whose staged body
    (6x6 blocks, ``k > 1``) reads no slot past a row's length; padded
    blocks are zero, so the result is the same either way and the vector
    entry and the plain version ignore it.  Each
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
                           b=b_blocks, x=x_blocks, d=d_blocks, coef=coef,
                           lengths=lengths)
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
            or tuple(coef.shape) != (2,)
            or (lengths is not None and tuple(lengths.shape) != (nbr,))):
        raise ValueError(f"{name}: operand shapes disagree with A "
                         f"{tuple(data.shape)}")
    backend.check_kernel_args(
        name, dict(data=data, dinv=dinv, b=b_blocks, x=x_blocks, d=d_blocks,
                   coef=coef), dict(indices=indices, lengths=lengths))
    ell_rows.check_payload(name, data)
    out = launch_lanes(indices, data, dinv, b_blocks, x_blocks, d_blocks,
                       coef, lanes, threads, accum_dtype, lengths=lengths)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[data.dtype]] += 1
    launches_by_shape[(bs, bs)] += 1
    k = vec[2] if len(vec) == 3 else 1
    launches_by_body["staged" if bs == 6 and k > 1 else "sub_warp"] += 1
    return out


def launch_lanes(indices: torch.Tensor, data: torch.Tensor,
                 dinv: torch.Tensor, b_blocks: torch.Tensor,
                 x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                 coef: torch.Tensor, lanes: int, threads: int,
                 accum_dtype=None, lengths: torch.Tensor | None = None):
    """``(x', d')`` from the kernel at an explicit ``lanes`` (the wrapper
    passes ``ell_rows.lanes``; the card tests and ``chip_smoke.py`` sweep
    it).  Takes checked CUDA tensors, counts no launch; the C entry points
    refuse a ``lanes`` that is not a power of two <= 32.  ``lengths`` goes
    to the panel entry (a null pointer for None); the vector entry takes
    none."""
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
        backend.launch(fn, _PANEL_ARGS, ptrs[0], p(lengths), *ptrs[1:], nbr,
                       kmax, bs, vec[2], lanes, threads)
    return x_new, d_new


@obs_trace.spanned("kernels/fused_smoother")
def smoother_step_scalar_ell(indices: torch.Tensor, data: torch.Tensor,
                             dinv: torch.Tensor, b_blocks: torch.Tensor,
                             x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                             coef: torch.Tensor, *,
                             threads: int | None = None, accum_dtype=None):
    """``(x', d')`` for one step on scalar rows with node blocks: A in 1x1
    padded ELL rows (``(nbr*bs, kmax)`` indices, ``(nbr*bs, kmax, 1, 1)``
    data), ``dinv (nbr, bs, bs)`` with ``bs`` in ``SHAPES``, ``(nbr, bs)``
    node vectors (node ``I`` owns scalar rows ``I*bs .. I*bs+bs-1``).
    Each row's ``A x`` takes ``ell_rows.lanes(1, 1, kmax)`` lanes, as
    ``block_spmv`` at 1x1, so it is bitwise ``block_spmv``'s.  ``threads``
    per CUDA block (default 256; not tuned) only sets how many nodes share
    a block.  Payloads and ``accum_dtype`` as ``smoother_step_ell``.  CPU
    tensors take the plain version (which also takes ``(nbr, bs, k)``
    panels); CUDA tensors the kernel, vectors only."""
    global launches
    name = "fused_smoother"
    cuda = backend.on_cuda(name, indices=indices, data=data, dinv=dinv,
                           b=b_blocks, x=x_blocks, d=d_blocks, coef=coef)
    nrows, kmax = data.shape[:2]
    nbr, bs = dinv.shape[:2]
    threads = autotune.DEFAULT_THREADS if threads is None else threads
    backend.check_threads(name, threads)
    lanes = ell_rows.lanes(1, 1, kmax)
    if not cuda:
        return smoother_step_scalar_ref(indices, data, dinv, b_blocks,
                                        x_blocks, d_blocks, coef,
                                        accum_dtype=accum_dtype)
    if bs not in SHAPES or tuple(data.shape[2:]) != (1, 1):
        raise ValueError(f"{name}: scalar rows of {tuple(data.shape[2:])} "
                         f"blocks with {tuple(dinv.shape[1:])} node blocks "
                         f"have no kernel instantiation (1x1, bs in "
                         f"{SHAPES})")
    if (tuple(dinv.shape) != (nbr, bs, bs) or nrows != nbr * bs
            or tuple(indices.shape) != (nrows, kmax)
            or any(tuple(v.shape) != (nbr, bs) for v in (b_blocks, x_blocks,
                                                         d_blocks))
            or tuple(coef.shape) != (2,)):
        raise ValueError(f"{name}: scalar-row operands disagree with A "
                         f"{tuple(data.shape)} and dinv {tuple(dinv.shape)} "
                         f"(vectors only on the card)")
    backend.check_kernel_args(
        name, dict(data=data, dinv=dinv, b=b_blocks, x=x_blocks, d=d_blocks,
                   coef=coef), dict(indices=indices))
    out = launch_scalar_lanes(indices, data, dinv, b_blocks, x_blocks,
                              d_blocks, coef, lanes, threads, accum_dtype)
    launches += 1
    launches_by_dtype[backend.PAYLOADS[data.dtype]] += 1
    launches_by_shape[(1, bs)] += 1
    launches_by_body["sub_warp"] += 1
    return out


def launch_scalar_lanes(indices: torch.Tensor, data: torch.Tensor,
                        dinv: torch.Tensor, b_blocks: torch.Tensor,
                        x_blocks: torch.Tensor, d_blocks: torch.Tensor,
                        coef: torch.Tensor, lanes: int, threads: int,
                        accum_dtype=None):
    """The scalar-row kernel at an explicit ``lanes`` (as
    ``launch_lanes``): checked CUDA tensors, no launch counted."""
    nbr, bs = dinv.shape[:2]
    x_new = torch.empty_like(b_blocks)
    d_new = torch.empty_like(b_blocks)
    p = backend.ptr
    fn = backend.entry("fused_smoother_scalar", data.dtype, accum_dtype,
                       bf16_f32=True)
    backend.launch(fn, _ARGS, p(indices), p(data), p(dinv), p(b_blocks),
                   p(x_blocks), p(d_blocks), p(coef), p(x_new), p(d_new),
                   nbr, data.shape[1], bs, lanes, threads)
    return x_new, d_new


def smoother_step_scalar(a_ell: BlockELL, dinv: torch.Tensor,
                         b: torch.Tensor, x: torch.Tensor, d: torch.Tensor,
                         coef: torch.Tensor, *, threads: int | None = None,
                         accum_dtype=None):
    """The scalar-row step on flat ``(n,)`` vectors (``(n, k)`` panels on
    the CPU), A in 1x1 ELL rows and ``dinv (n // bs, bs, bs)``; returns
    ``(x', d')``."""
    shape = tuple(dinv.shape[:2]) + tuple(b.shape[1:])
    x_new, d_new = smoother_step_scalar_ell(
        a_ell.indices, a_ell.data, dinv, b.reshape(shape), x.reshape(shape),
        d.reshape(shape), coef, threads=threads, accum_dtype=accum_dtype)
    return x_new.reshape(b.shape), d_new.reshape(b.shape)


def smoother_step(a_ell: BlockELL, dinv: torch.Tensor, b: torch.Tensor,
                  x: torch.Tensor, d: torch.Tensor, coef: torch.Tensor, *,
                  threads: int | None = None, accum_dtype=None):
    """The fused step on flat ``(n,)`` vectors or ``(n, k)`` panels, with
    the ELL's row lengths; returns ``(x', d')``."""
    shape = (a_ell.nbr, a_ell.br) + tuple(b.shape[1:])
    x_new, d_new = smoother_step_ell(a_ell.indices, a_ell.data, dinv,
                                     b.reshape(shape), x.reshape(shape),
                                     d.reshape(shape), coef, threads=threads,
                                     accum_dtype=accum_dtype,
                                     lengths=a_ell.lengths)
    return x_new.reshape(b.shape), d_new.reshape(b.shape)
