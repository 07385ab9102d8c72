"""Solve health flags (torch twin of ``repro.robust.health``).

The Krylov loop carries, beside its CG state: ``nonfinite`` (NaN/Inf in the
residual norm, ``p·Ap`` or ``r·z``), ``breakdown`` (non-positive ``p·Ap``
or ``r·z`` on an active step) and ``stagnation`` (no new best residual for
``stall_window`` iterations).  All come from reductions the recurrence
already computes.  Severity order: ``NONFINITE`` > ``BREAKDOWN`` >
``STAGNATION`` > ``MAXITER`` > ``HEALTHY``.
"""
from __future__ import annotations

from typing import NamedTuple

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
