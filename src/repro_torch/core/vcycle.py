"""Device-resident V-cycle (torch twin of ``repro.core.vcycle``; paper
Sec. 3.1).

Expressed over the padded BlockELL layout: SpMV with the level operator
and prolongation through the ``block_spmv`` kernel (``block_spmm`` on
panels), restriction off P's own blocks (transpose-free, the default) or
through the same kernels on a stored ``r_ell``,
pbjacobi-preconditioned Chebyshev (or damped block-Jacobi) smoothing — by
default each recurrence step is one ``fused_smoother`` kernel launch —
and a dense Cholesky coarse solve.  Every step takes a vector ``(n,)`` or
a column panel ``(n, k)``, so the multi-RHS solve runs this same cycle.
Nothing in the cycle waits on the host: the Chebyshev coefficients are
device scalars derived from the device ``lam_max``.  Each stage runs in a
span (``vcycle/level{i}/smooth|restrict|prolong``, ``vcycle/coarse``;
``repro_torch.obs.trace``), and with a ``tally=`` the cycle counts its
level visits, smoother applications and coarse solve on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.block_csr import BlockELL, EllTransposePlan
from repro_torch.core.spmv import apply_ell, apply_ell_t
from repro_torch.kernels import backend
from repro_torch.kernels.fused_smoother import ops as smoother_ops
from repro_torch.obs import trace as obs_trace
from repro_torch.robust import inject


@dataclasses.dataclass
class LevelState:
    """Numeric per-level state; structure lives in the setup's plans."""

    a_ell: BlockELL                 # level operator (bs x bs, or 1x1 blocks)
    p_ell: BlockELL                 # prolongator (bs_f x bs_c), fixed values
    dinv: torch.Tensor              # (nbr, bs, bs) inverted diagonal blocks
    lam_max: torch.Tensor           # Chebyshev upper bound for D^-1 A
    p_t: Optional[EllTransposePlan] = None   # transpose-free P^T plan
    r_ell: Optional[BlockELL] = None         # stored restriction P^T


@dataclasses.dataclass
class Hierarchy:
    """Device-resident numeric hierarchy, stored at the policy's
    ``hierarchy_dtype``.  ``a_fine_ell`` is set by mixed-precision
    policies only: a krylov-dtype copy of the finest operator for the
    outer iteration, so its residual never sees the hierarchy's rounding
    (the smoother keeps ``levels[0].a_ell``)."""

    levels: Tuple[LevelState, ...]
    coarse_chol: torch.Tensor       # lower Cholesky factor, coarsest level
    a_fine_ell: Optional[BlockELL] = None   # krylov-dtype finest operator


def fine_operator(hier: Hierarchy) -> BlockELL:
    """The finest-level operator the Krylov loop applies: the krylov-dtype
    copy under a mixed policy, else level 0's operator."""
    return hier.a_fine_ell if hier.a_fine_ell is not None \
        else hier.levels[0].a_ell


def pbjacobi_apply(dinv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Point-block Jacobi apply; ``r`` is ``(n,)`` or a panel ``(n, k)``."""
    nbr, bs = dinv.shape[0], dinv.shape[1]
    tail = tuple(r.shape[1:])
    out = torch.einsum("nab,nb...->na...", dinv, r.reshape((nbr, bs) + tail))
    return out.contiguous().reshape((nbr * bs,) + tail)


def chebyshev_recurrence(spmv, pbj, lam_max, b, x, degree: int = 2,
                         lo_frac: float = 0.1, hi_frac: float = 1.05):
    """pbjacobi-preconditioned Chebyshev on [lo_frac, hi_frac]*lam_max
    (the unfused recurrence, same constants as the reference)."""
    lo = lo_frac * lam_max
    hi = hi_frac * lam_max
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - spmv(x)
    z = pbj(r)
    d = z / theta
    x = x + d
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = r - spmv(d)
        z = pbj(r)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


def pbjacobi_recurrence(spmv, pbj, b, x, its: int = 2, omega: float = 0.6):
    """Damped point-block Jacobi (unfused)."""
    for _ in range(its):
        r = b - spmv(x)
        x = x + omega * pbj(r)
    return x


def chebyshev_smooth(lv: LevelState, b, x, degree: int = 2,
                     lo_frac: float = 0.1, hi_frac: float = 1.05):
    return chebyshev_recurrence(lambda v: apply_ell(lv.a_ell, v),
                                lambda r: pbjacobi_apply(lv.dinv, r),
                                lv.lam_max, b, x, degree, lo_frac, hi_frac)


def pbjacobi_smooth(lv: LevelState, b, x, omega: float = 0.6,
                    its: int = 2):
    return pbjacobi_recurrence(lambda v: apply_ell(lv.a_ell, v),
                               lambda r: pbjacobi_apply(lv.dinv, r),
                               b, x, its, omega)


def _coef(c1, c2, like: torch.Tensor) -> torch.Tensor:
    """``[c1, c2]`` as a two-element device tensor; Python numbers are
    filled on the device, so no host copy or sync is involved."""
    def dev(c):
        if isinstance(c, torch.Tensor):
            return c.to(like.dtype)
        return torch.full((), c, dtype=like.dtype, device=like.device)
    return torch.stack([dev(c1), dev(c2)])


def _fused_step(lv: LevelState, b, x, d, coef):
    """One fused step ``d' = c1 d + c2 D^-1 (b - A x); x' = x + d'``.  A
    level of the scalar baseline (``core.scalar_path``: ``a_ell`` of 1x1
    blocks, ``dinv`` of node blocks) takes the scalar-row step."""
    if lv.a_ell.br == 1 and lv.dinv.shape[-1] > 1:
        return smoother_ops.smoother_step_scalar(lv.a_ell, lv.dinv, b, x, d,
                                                 coef)
    return smoother_ops.smoother_step(lv.a_ell, lv.dinv, b, x, d, coef)


def chebyshev_smooth_fused(lv: LevelState, b, x, degree: int = 2,
                           lo_frac: float = 0.1, hi_frac: float = 1.05):
    """Chebyshev smoothing with each recurrence step as one fused kernel
    launch; the residual is formed fresh from the current iterate, which
    differs from the unfused recurrence only in rounding."""
    lo = lo_frac * lv.lam_max
    hi = hi_frac * lv.lam_max
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    x, d = _fused_step(lv, b, x, torch.zeros_like(b),
                       _coef(0.0, 1.0 / theta, b))
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        x, d = _fused_step(lv, b, x, d,
                           _coef(rho_new * rho, 2.0 * rho_new / delta, b))
        rho = rho_new
    return x


def pbjacobi_smooth_fused(lv: LevelState, b, x, omega: float = 0.6,
                          its: int = 2):
    """Damped point-block Jacobi with each step as one fused launch."""
    d = torch.zeros_like(b)
    coef = _coef(0.0, omega, b)
    for _ in range(its):
        x, d = _fused_step(lv, b, x, d, coef)
    return x


def apply_smoother(lv, b, x, smoother: str, degree: int,
                   path: str | None = None):
    """Smoother-name dispatch; ``path`` (``REPRO_TORCH_SMOOTH_PATH``)
    picks the fused kernel ("fused", default) or, on the CPU only, the
    unfused recurrences ("reference")."""
    if backend.resolve_smooth_path(b.device, path) == "fused":
        if smoother == "chebyshev":
            return chebyshev_smooth_fused(lv, b, x, degree=degree)
        return pbjacobi_smooth_fused(lv, b, x, its=degree)
    if smoother == "chebyshev":
        return chebyshev_smooth(lv, b, x, degree=degree)
    return pbjacobi_smooth(lv, b, x, its=degree)


def apply_restriction(lv: LevelState, r: torch.Tensor) -> torch.Tensor:
    """Restrict a fine-level residual, ``P^T r``: through the stored
    ``r_ell`` when the level carries one (``block_spmv`` on vectors,
    ``block_spmm`` on panels), else off ``p_ell``'s own blocks."""
    if lv.r_ell is not None:
        return apply_ell(lv.r_ell, r)
    return apply_ell_t(lv.p_ell, lv.p_t, r)


def coarse_solve(chol: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The coarse direct solve with the lower Cholesky factor ``chol`` on
    a vector ``(n,)`` or a panel ``(n, k)``.  ``cholesky_solve`` has no
    bf16 kernel on either device: a bf16 factor solves at f32 (the
    policy's factor dtype) and rounds to ``rhs``'s dtype.  It returns
    column-major panels; the kernels take row-major ones."""
    fd = torch.float32 if chol.dtype == torch.bfloat16 else chol.dtype
    return torch.cholesky_solve(rhs.reshape(rhs.shape[0], -1).to(fd),
                                chol.to(fd)).to(rhs.dtype).contiguous() \
        .reshape(rhs.shape)


def vcycle(hier: Hierarchy, b: torch.Tensor, smoother: str = "chebyshev",
           degree: int = 2, tally: "obs_trace.CycleTally | None" = None):
    """One V(degree, degree) cycle with zero initial guess (the
    preconditioner), on a vector ``(n,)`` or a panel ``(n, k)``.

    With a ``tally`` (``obs.trace.CycleTally``) it returns ``(x,
    tally')``: one preconditioner application, a visit and a smoother
    application per level on the way down, one coarse solve, a smoother
    application per level on the way up, at the reference's places.
    ``tally=None`` returns ``x`` and dispatches the uncounted ops."""
    span = obs_trace.span
    counted = tally is not None
    bs_stack, x_stack = [], []
    rhs = b
    if counted:
        tally = tally._replace(precond_applies=tally.precond_applies + 1)
    for li, lv in enumerate(hier.levels):
        with span(f"vcycle/level{li}/smooth"):
            x = apply_smoother(lv, rhs, torch.zeros_like(rhs), smoother,
                               degree)
        r = rhs - apply_ell(lv.a_ell, x)
        bs_stack.append(rhs)
        x_stack.append(x)
        # fault sites (repro_torch.robust.inject): x itself unless a
        # schedule is installed
        with span(f"vcycle/level{li}/restrict"):
            rhs = inject.maybe("vcycle", apply_restriction(lv, r), level=li)
        if counted:
            tally = tally._replace(
                level_visits=obs_trace.bump(tally.level_visits, li),
                smoother_applies=obs_trace.bump(tally.smoother_applies, li))
    with span("vcycle/coarse"):
        xc = inject.maybe("coarse", coarse_solve(hier.coarse_chol, rhs))
    if counted:
        tally = tally._replace(coarse_solves=tally.coarse_solves + 1)
    nlev = len(hier.levels)
    for up, (lv, rhs_l, x) in enumerate(zip(reversed(hier.levels),
                                            reversed(bs_stack),
                                            reversed(x_stack))):
        li = nlev - 1 - up
        with span(f"vcycle/level{li}/prolong"):
            x = x + apply_ell(lv.p_ell, xc)          # prolong + correct
        with span(f"vcycle/level{li}/smooth"):
            xc = apply_smoother(lv, rhs_l, x, smoother, degree)
        if counted:
            tally = tally._replace(
                smoother_applies=obs_trace.bump(tally.smoother_applies, li))
    return (xc, tally) if counted else xc


def vcycle_apply_op(hier: Hierarchy, x: torch.Tensor) -> torch.Tensor:
    """Finest-level operator application (for the Krylov wrapper)."""
    return apply_ell(fine_operator(hier), x)
