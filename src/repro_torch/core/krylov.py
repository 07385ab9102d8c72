"""Preconditioned conjugate gradients (torch twin of ``repro.core.krylov``).

Convergence is monitored on the unpreconditioned residual norm (paper
Sec. 4.1).  The reference's ``while_loop`` becomes a Python loop whose exit
test is one host sync per iteration; everything else — the health flags,
the discarded broken step, the best (minimum-residual) iterate returned on
a non-converged exit, the ``finfo.tiny`` floor of ``||b||`` — stays on the
device and follows the reference step for step.  The fault-injection
sites ``spmv`` and ``precond`` (``repro_torch.robust.inject``) sit where
the reference's do, gated on the host iteration counter.  With a
``tally=`` (``repro_torch.obs.trace.CycleTally``) the loop also counts
operator and preconditioner applications on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.obs import trace as obs_trace
from repro_torch.robust import inject
from repro_torch.robust.health import SolveHealth, status_of


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    relres: torch.Tensor
    converged: torch.Tensor
    health: SolveHealth
    # the device solve counters (obs.trace.CycleTally) of a counted
    # solve; None otherwise
    counters: "obs_trace.CycleTally | None" = None


def wrap_precond(apply_m: Callable[[torch.Tensor], torch.Tensor],
                 precond_dtype, outer_dtype):
    """The mixed-precision preconditioner boundary: cast the residual to
    ``precond_dtype`` before ``apply_m`` and the direction back after;
    ``apply_m`` itself when no cast is needed."""
    if precond_dtype is None or precond_dtype == outer_dtype:
        return apply_m

    def wrapped(r):
        return apply_m(r.to(precond_dtype)).to(outer_dtype)

    return wrapped


def pcg(apply_a: Callable[[torch.Tensor], torch.Tensor],
        apply_m: Callable[[torch.Tensor], torch.Tensor],
        b: torch.Tensor, x0: torch.Tensor | None = None, rtol: float = 1e-8,
        maxiter: int = 200, precond_dtype=None,
        stall_window: int = 40, tally=None, *, dot=torch.dot,
        norm=torch.linalg.vector_norm) -> CGResult:
    """Standard PCG with a fixed SPD preconditioner (one AMG V-cycle).

    ``x0`` warm-starts the iteration (``None``: zero start).  The loop
    exits on convergence, ``maxiter``, a non-finite residual, CG breakdown
    or ``stall_window`` iterations without a new best residual; a broken
    step's update is discarded, and a non-converged exit returns the
    minimum-residual iterate.

    ``tally`` (an ``obs.trace.CycleTally``) threads the device counters:
    ``apply_m`` then has the form ``(r, tally) -> (z, tally)`` (``vcycle``
    with ``tally=``), each operator apply adds 1 to ``operator_applies``,
    and the result's ``counters`` holds the totals.  ``None`` (default)
    leaves the recurrence and its ops exactly the uncounted ones.

    ``dot`` and ``norm`` are the recurrence's reductions; the distributed
    solve (``repro_torch.dist.solver._rank_pcg``) passes rank-reduced
    ones over row slabs, as the reference's ``_rank_pcg`` uses ``psum``.
    """
    counted = tally is not None
    if counted:
        apply_m = obs_trace.wrap_threaded_precond(apply_m, precond_dtype,
                                                  b.dtype)
    else:
        apply_m = wrap_precond(apply_m, precond_dtype, b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_a(x)
    if counted:
        tally = tally._replace(operator_applies=tally.operator_applies + 1)
        z, tally = apply_m(r, tally)
    else:
        z = apply_m(r)
    p = z
    rz = dot(r, z)
    bnorm = torch.clamp_min(norm(b), torch.finfo(b.dtype).tiny)
    thresh = rtol * bnorm
    rnorm = norm(r)
    nonf = ~torch.isfinite(rnorm) | ~torch.isfinite(rz)
    brk = ~nonf & (rz <= 0) & (rnorm > thresh)
    best_x = x
    best_rnorm = torch.where(torch.isfinite(rnorm), rnorm,
                             torch.full_like(rnorm, float("inf")))
    best_k = torch.zeros((), dtype=torch.int32, device=b.device)
    stall = torch.zeros((), dtype=torch.int32, device=b.device)
    k = 0
    while k < maxiter:
        go = (rnorm > thresh) & ~brk & ~nonf & (stall < stall_window)
        if not bool(go):                 # the one host sync per iteration
            break
        Ap = inject.maybe("spmv", apply_a(p), step=k)
        pAp = dot(p, Ap)
        alpha = rz / pAp
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        if counted:
            tally = tally._replace(
                operator_applies=tally.operator_applies + 1)
            z_new, tally = apply_m(r_new, tally)
            z_new = inject.maybe("precond", z_new, step=k)
        else:
            z_new = inject.maybe("precond", apply_m(r_new), step=k)
        rz_new = dot(r_new, z_new)
        beta = rz_new / rz
        p_new = z_new + beta * p
        rnorm_new = norm(r_new)
        nonf_new = (~torch.isfinite(pAp) | ~torch.isfinite(rnorm_new)
                    | ~torch.isfinite(rz_new))
        brk_new = ~nonf_new & ((pAp <= 0)
                               | ((rz_new <= 0) & (rnorm_new > thresh)))
        ok = ~(nonf_new | brk_new)
        x = torch.where(ok, x_new, x)
        r = torch.where(ok, r_new, r)
        z = torch.where(ok, z_new, z)
        p = torch.where(ok, p_new, p)
        rz = torch.where(ok, rz_new, rz)
        rnorm = torch.where(ok, rnorm_new, rnorm)
        improved = ok & (rnorm_new < best_rnorm)
        best_x = torch.where(improved, x_new, best_x)
        best_rnorm = torch.where(improved, rnorm_new, best_rnorm)
        best_k = torch.where(improved, k + 1, best_k).to(torch.int32)
        stall = torch.where(improved, 0, stall + 1).to(torch.int32)
        brk = brk | brk_new
        nonf = nonf | nonf_new
        k += 1
    converged = rnorm <= thresh
    x_out = torch.where(converged, x, best_x)
    rnorm_out = torch.where(converged, rnorm, best_rnorm)
    stag = ~converged & ~brk & ~nonf & (stall >= stall_window)
    health = SolveHealth(
        status=status_of(converged, brk, nonf, stag), breakdown=brk,
        nonfinite=nonf, stagnation=stag, best_iter=best_k,
        best_relres=best_rnorm / bnorm)
    return CGResult(x=x_out, iters=k, relres=rnorm_out / bnorm,
                    converged=converged, health=health, counters=tally)
