"""Batched PCG over column panels with per-column convergence masking
(torch twin of ``repro.multirhs.block_krylov``).

One Krylov iteration on an ``(n, k)`` panel runs the operator and the AMG
preconditioner as panel products — the ``block_spmm`` and panel
``fused_smoother`` kernels stream each level operator once for all ``k``
columns — while every CG scalar (``alpha``, ``beta``, ``rz``) becomes a
length-``k`` vector of per-column reductions.  CG columns are
independent, so masking converged columns (their step frozen at zero)
reproduces the dedicated single-RHS trajectories column by column: the
same iteration counts, the same solutions to rounding.

Health rides the same masks: a column whose recurrence goes NaN/Inf,
breaks down or stagnates is quarantined — its broken step is discarded,
it freezes like a converged column, and its panel neighbours keep
iterating.  As in ``repro_torch.core.krylov.pcg`` the reference's
``while_loop`` is a Python loop whose exit test, ``bool(active.any())``,
is the one host sync per iteration; everything else stays on the device
and follows the reference step for step, the fault-injection sites
``spmv`` and ``precond`` included.  With a ``tally=`` the panel counts its
applications on the device (``repro_torch.obs.trace``), one operator apply
and one V-cycle per iteration for all columns, as the reference does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.krylov import wrap_precond
from repro_torch.core.spmv import apply_ell
from repro_torch.core.vcycle import Hierarchy, fine_operator, vcycle
from repro_torch.obs import trace as obs_trace
from repro_torch.robust import inject
from repro_torch.robust.health import SolveHealth, status_of


class BlockCGResult(NamedTuple):
    x: torch.Tensor          # (n, k) solutions
    iters: torch.Tensor      # (k,) int32 iterations applied to each column
    relres: torch.Tensor     # (k,) final per-column relative residual
    converged: torch.Tensor  # (k,) bool
    health: SolveHealth      # per-column (k,) health record
    # the device solve counters of a counted panel solve; None otherwise
    counters: "obs_trace.CycleTally | None" = None


def _col_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-column dot: reduce every axis but the trailing panel axis."""
    return torch.sum(a * b, dim=tuple(range(a.ndim - 1)))


def _col_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(a * a, dim=tuple(range(a.ndim - 1))))


def block_pcg(apply_a: Callable[[torch.Tensor], torch.Tensor],
              apply_m: Callable[[torch.Tensor], torch.Tensor],
              B: torch.Tensor, x0: torch.Tensor | None = None,
              rtol: float = 1e-8, maxiter: int = 200, *,
              col_dot=_col_dot, col_norm=_col_norm, precond_dtype=None,
              stall_window: int = 40, record_history: bool = False,
              tally=None):
    """PCG on a panel ``B (..., k)`` with per-column masking.

    ``x0`` warm-starts every column from a prior ``(..., k)`` panel
    (``None``: zero start); a column seeded within tolerance is inactive
    from iteration 0.  A column is active while its residual exceeds
    ``rtol * ||b_col||`` and no health flag has tripped; frozen columns
    take ``alpha = 0`` and keep their CG state.  Zero columns are inactive
    from the start (iterations 0, converged, relres 0: the
    ``finfo(B.dtype).tiny`` floor), which makes the solve server's padding
    columns free.  A non-converged column returns its minimum-residual
    iterate.

    ``record_history=True`` also returns a ``(maxiter, k)`` tensor of
    per-column residual norms: ``[i, c]`` is column ``c``'s ``||r||``
    after iteration ``i + 1``, NaN once the column froze.

    ``tally`` threads the device counters as in ``core.krylov.pcg``
    (``apply_m`` then ``(R, tally) -> (Z, tally)``): one operator and one
    preconditioner application per iteration for the whole panel.
    """
    counted = tally is not None
    if counted:
        apply_m = obs_trace.wrap_threaded_precond(apply_m, precond_dtype,
                                                  B.dtype)
    else:
        apply_m = wrap_precond(apply_m, precond_dtype, B.dtype)
    x = torch.zeros_like(B) if x0 is None else x0
    r = B - apply_a(x)
    if counted:
        tally = tally._replace(operator_applies=tally.operator_applies + 1)
        z, tally = apply_m(r, tally)
    else:
        z = apply_m(r)
    p = z
    rz = col_dot(r, z)
    bnorm = torch.clamp_min(col_norm(B), torch.finfo(B.dtype).tiny)
    thresh = rtol * bnorm
    rnorm = col_norm(r)
    nonf = ~torch.isfinite(rnorm) | ~torch.isfinite(rz)
    brk = ~nonf & (rz <= 0) & (rnorm > thresh)
    ncol = B.shape[-1]
    dev = B.device
    iters = torch.zeros(ncol, dtype=torch.int32, device=dev)
    # a NaN initial residual must not poison the best-so-far tracking
    best_x = x
    best_rnorm = torch.where(torch.isfinite(rnorm), rnorm,
                             torch.full_like(rnorm, float("inf")))
    best_iter = torch.zeros(ncol, dtype=torch.int32, device=dev)
    stall = torch.zeros(ncol, dtype=torch.int32, device=dev)
    hist = (torch.full((maxiter, ncol), float("nan"), dtype=rnorm.dtype,
                       device=dev) if record_history else None)
    k = 0
    while k < maxiter:
        active = (rnorm > thresh) & ~brk & ~nonf & (stall < stall_window)
        with obs_trace.host_span("sync/block_cg_exit"):
            go = bool(active.any())       # the one host sync per iteration
        if not go:
            break
        Ap = inject.maybe("spmv", apply_a(p), step=k)
        pAp = col_dot(p, Ap)
        # frozen columns: guard the denominators, zero the step
        alpha = torch.where(active, rz / torch.where(active, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        if counted:
            tally = tally._replace(
                operator_applies=tally.operator_applies + 1)
            z_new, tally = apply_m(r_new, tally)
            z_new = inject.maybe("precond", z_new, step=k)
        else:
            z_new = inject.maybe("precond", apply_m(r_new), step=k)
        rz_new = col_dot(r_new, z_new)
        beta = torch.where(active, rz_new / torch.where(active, rz, 1.0),
                           0.0)
        rnorm_new = col_norm(r_new)
        nonf_new = active & (~torch.isfinite(pAp)
                             | ~torch.isfinite(rnorm_new)
                             | ~torch.isfinite(rz_new))
        brk_new = active & ~nonf_new & ((pAp <= 0)
                                        | ((rz_new <= 0)
                                           & (rnorm_new > thresh)))
        ok = active & ~nonf_new & ~brk_new
        # a broken column's step is discarded: it keeps its last healthy
        # state, is quarantined by its flag, and its neighbours continue
        moved = ok | ~active
        x = torch.where(moved, x_new, x)
        r = torch.where(moved, r_new, r)
        p = torch.where(ok, z_new + beta * p, p)
        z = torch.where(ok, z_new, z)
        rz = torch.where(ok, rz_new, rz)
        rnorm = torch.where(ok, rnorm_new, rnorm)
        improved = ok & (rnorm_new < best_rnorm)
        best_x = torch.where(improved, x_new, best_x)
        best_rnorm = torch.where(improved, rnorm_new, best_rnorm)
        best_iter = torch.where(improved, k + 1, best_iter).to(torch.int32)
        stall = torch.where(improved, 0,
                            stall + active.to(torch.int32)).to(torch.int32)
        iters = iters + active.to(torch.int32)
        if hist is not None:
            hist[k] = torch.where(ok, rnorm_new, float("nan"))
        brk = brk | brk_new
        nonf = nonf | nonf_new
        k += 1
    converged = rnorm <= thresh
    x_out = torch.where(converged, x, best_x)
    rnorm_out = torch.where(converged, rnorm, best_rnorm)
    stag = ~converged & ~brk & ~nonf & (stall >= stall_window)
    health = SolveHealth(
        status=status_of(converged, brk, nonf, stag), breakdown=brk,
        nonfinite=nonf, stagnation=stag, best_iter=best_iter,
        best_relres=best_rnorm / bnorm)
    res = BlockCGResult(x=x_out, iters=iters, relres=rnorm_out / bnorm,
                        converged=converged, health=health, counters=tally)
    return (res, hist) if record_history else res


def make_block_solve(setupd, rtol: float = 1e-8, maxiter: int = 200,
                     record_history: bool = False, obs: str | None = None):
    """Hot panel solve ``(Hierarchy, B (n, k), x0=None) -> BlockCGResult``
    (``(result, history)`` under ``record_history=True``): the multi-RHS
    twin of ``repro_torch.core.gamg.hier_solve``, with the same smoother
    configuration and panel products everywhere.  The fault schedule in
    force at the first call with each panel shape holds for every later
    call with it (``robust.inject.traced``), as the reference's per-shape
    traces do.  ``obs`` (None: the ``use`` scope, else
    ``REPRO_TORCH_OBS``) is resolved here; under ``"counters"`` the panel
    threads a ``CycleTally`` and ``counters`` carries it with the modeled
    bytes of its cycles."""
    smoother, degree = setupd.smoother, setupd.degree
    precond_dtype = setupd.precision.smoother_dtype
    mode = obs_trace.resolve(obs)
    counted = obs_trace.counters_enabled(mode)
    if counted:
        from repro_torch.obs.model import cycle_bytes
        per_cycle = cycle_bytes(setupd)

    def solve(hier: Hierarchy, B: torch.Tensor,
              x0: torch.Tensor | None = None):
        def apply_a(X):
            return apply_ell(fine_operator(hier), X)

        if counted:
            def apply_m(R, tl):
                return vcycle(hier, R, smoother=smoother, degree=degree,
                              tally=tl)
            tally = obs_trace.zero_tally(setupd.n_levels, B.device)
        else:
            def apply_m(R):
                return vcycle(hier, R, smoother=smoother, degree=degree)
            tally = None

        out = block_pcg(apply_a, apply_m, B, x0=x0, rtol=rtol,
                        maxiter=maxiter, precond_dtype=precond_dtype,
                        record_history=record_history, tally=tally)
        if not counted:
            return out
        res, hist = out if record_history else (out, None)
        res = res._replace(counters=obs_trace.attach_model_bytes(
            res.counters, per_cycle))
        return (res, hist) if record_history else res

    return inject.traced(solve, obs=mode)
