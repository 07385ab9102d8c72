"""Precision policy — dtype roles of the AMG stack (twin of
``repro.core.precision``).

Four roles, as in the reference: ``hierarchy_dtype`` (level payloads,
transfer payloads, ``dinv``, coarse factor), ``smoother_dtype`` (what the
V-cycle runs at), ``krylov_dtype`` (outer CG) and ``accum_dtype`` (kernel
accumulators).  This port runs the all-f64 policy, the paper's setting and
the f64 contract of the exact-parity tests.  The reduced-precision stock
policies (``"f32"``, ``"bf16"``) are named but raise: their kernels'
instantiations and the mixed-precision preconditioner boundary are queued
in ROADMAP.md ("precision policies below f64").
"""
from __future__ import annotations

import dataclasses

import torch

_NAMES = ("f64", "f32", "bf16")


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Frozen dtype assignment for one solver configuration."""

    hierarchy_dtype: torch.dtype
    smoother_dtype: torch.dtype
    krylov_dtype: torch.dtype
    accum_dtype: torch.dtype

    @staticmethod
    def double() -> "PrecisionPolicy":
        """All-fp64 (the paper's setting)."""
        return PrecisionPolicy(torch.float64, torch.float64, torch.float64,
                               torch.float64)

    @staticmethod
    def from_name(name: str) -> "PrecisionPolicy":
        if not isinstance(name, str):
            raise ValueError(f"precision must be a name: {name!r}")
        key = name.strip().lower()
        if key in ("f64", "fp64", "float64", "double"):
            return PrecisionPolicy.double()
        if key in ("f32", "fp32", "float32", "single", "bf16", "bfloat16"):
            raise ValueError(
                f"precision {name!r} is not ported yet: repro_torch runs the "
                f"f64 policy only (ROADMAP.md, 'precision policies below "
                f"f64')")
        raise ValueError(
            f"invalid precision {name!r}: expected one of {_NAMES} "
            f"(the precision= knob)")

    @property
    def factor_dtype(self) -> torch.dtype:
        """Dtype of the dense factorizations (diag inverses, coarse
        Cholesky)."""
        return self.hierarchy_dtype

    def coarse_jitter_scale(self) -> float:
        """Relative diagonal jitter of the coarse Cholesky (f64: 1e-12)."""
        return 1e-12

    def coarse_retry_scale(self) -> float:
        """Escalated jitter of the one coarse-Cholesky retry:
        ``sqrt(eps)`` of the factor dtype."""
        return float(torch.finfo(self.factor_dtype).eps) ** 0.5
