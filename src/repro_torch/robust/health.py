"""Solve health flags (torch twin of ``repro.robust.health``).

The Krylov loop carries, beside its CG state: ``nonfinite`` (NaN/Inf in the
residual norm, ``p·Ap`` or ``r·z``), ``breakdown`` (non-positive ``p·Ap``
or ``r·z`` on an active step) and ``stagnation`` (no new best residual for
``stall_window`` iterations).  All come from reductions the recurrence
already computes.  Severity order: ``NONFINITE`` > ``BREAKDOWN`` >
``STAGNATION`` > ``MAXITER`` > ``HEALTHY``, and the codes are numbered in
that order, so the worst of many is their maximum (``worst_status``).
``describe`` and ``summarize_statuses`` are host-side summaries (they
sync); ``hierarchy_finite`` is the recovery ladder's check of a whole
hierarchy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

HEALTHY = 0      # converged, no flags
MAXITER = 1      # ran out of iterations, no breakdown — best iterate returned
STAGNATION = 2   # no residual progress over the stall window
BREAKDOWN = 3    # non-positive p·Ap / r·z: lost positive-definiteness
NONFINITE = 4    # NaN/Inf reached the recurrence

STATUS_NAMES = {HEALTHY: "healthy", MAXITER: "maxiter",
                STAGNATION: "stagnation", BREAKDOWN: "breakdown",
                NONFINITE: "nonfinite"}


class SolveHealth(NamedTuple):
    """Structured health record on a ``CGResult`` (device tensors)."""

    status: torch.Tensor       # int32 code (see STATUS_NAMES)
    breakdown: torch.Tensor    # bool
    nonfinite: torch.Tensor    # bool
    stagnation: torch.Tensor   # bool
    best_iter: torch.Tensor    # int32 iteration index of the best iterate
    best_relres: torch.Tensor  # minimum relative residual seen


def status_of(converged: torch.Tensor, breakdown: torch.Tensor,
              nonfinite: torch.Tensor,
              stagnation: torch.Tensor) -> torch.Tensor:
    """Fold the flags into one int32 code, most severe wins."""
    code = torch.where(converged, HEALTHY, MAXITER)
    code = torch.where(stagnation, STAGNATION, code)
    code = torch.where(breakdown, BREAKDOWN, code)
    code = torch.where(nonfinite, NONFINITE, code)
    return code.to(torch.int32)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def describe(health: SolveHealth) -> str:
    """Host-side, human-readable one-liner (syncs; not for the hot loop)."""
    status = np.atleast_1d(np.asarray(_host(health.status)))
    best = np.atleast_1d(np.asarray(_host(health.best_relres)))
    names = [STATUS_NAMES.get(int(s), f"?{int(s)}") for s in status]
    return " ".join(f"{n}(best_relres={float(b):.3e})"
                    for n, b in zip(names, best))


def worst_status(statuses):
    """Fold many status codes into one, the most severe: their maximum.
    A tensor (or a sequence of tensors) gives an int32 tensor on its
    device, with no host sync; anything else (numpy, ints) an int32
    numpy scalar."""
    if isinstance(statuses, (list, tuple)) and statuses \
            and all(isinstance(s, torch.Tensor) for s in statuses):
        statuses = torch.stack([s.reshape(()) if s.numel() == 1 else s
                                for s in statuses])
    if isinstance(statuses, torch.Tensor):
        return statuses.to(torch.int32).max()
    return np.asarray(statuses, np.int32).max()


def summarize_statuses(statuses) -> dict:
    """Host-side summary: ``{status_name: count}`` over the codes (only
    names that occur), plus ``"worst"``.  Syncs; not for the hot loop."""
    codes = np.asarray(_host(statuses)).reshape(-1).astype(np.int64)
    out = {}
    for code in np.unique(codes):
        name = STATUS_NAMES.get(int(code), f"?{int(code)}")
        out[name] = int((codes == code).sum())
    out["worst"] = STATUS_NAMES.get(
        int(codes.max()) if codes.size else HEALTHY, "?")
    return out


def hierarchy_finite(hier) -> torch.Tensor:
    """Device bool: every floating payload of a ``Hierarchy`` is finite —
    each level's operator, prolongator, stored restriction, ``dinv`` and
    ``lam_max``, the coarse factor and the Krylov copy of the finest
    operator (the port has no pytrees, so the fields are named here)."""
    tensors = [hier.coarse_chol]
    for lv in hier.levels:
        tensors += [lv.a_ell.data, lv.p_ell.data, lv.dinv, lv.lam_max]
        if lv.r_ell is not None:
            tensors.append(lv.r_ell.data)
    if hier.a_fine_ell is not None:
        tensors.append(hier.a_fine_ell.data)
    ok = torch.ones((), dtype=torch.bool, device=hier.coarse_chol.device)
    for t in tensors:
        ok = ok & torch.isfinite(t).all()
    return ok
