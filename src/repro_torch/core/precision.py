"""Precision policy — dtype roles of the AMG stack (twin of
``repro.core.precision``).

Four roles, as in the reference: ``hierarchy_dtype`` (level payloads,
transfer payloads, ``dinv``, coarse factor), ``smoother_dtype`` (what the
V-cycle runs at), ``krylov_dtype`` (outer CG and the finest operator it
applies) and ``accum_dtype`` (kernel accumulators).  The stock policies:

``"f64"``   all double (the paper's setting, the f64 contract of the
            exact-parity tests).
``"f32"``   an fp32-resident hierarchy and smoother under an fp64 outer
            CG, fp32 accumulators.
``"bf16"``  a bf16-resident hierarchy and smoother under an fp64 outer
            CG, fp32 accumulators; the dense factorizations run at fp32
            (``factor_dtype``: neither LAPACK nor cuSOLVER has bf16).

Policies are resolved by ``repro_torch.kernels.backend.resolve_precision``
(``None``: the ``REPRO_TORCH_PRECISION`` variable, default "f64").
"""
from __future__ import annotations

import dataclasses

import torch

_NAMES = ("f64", "f32", "bf16")
# the reference's numpy names, so that ``describe()`` strings compare equal
_NP_NAMES = {torch.float64: "float64", torch.float32: "float32",
             torch.bfloat16: "bfloat16"}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Frozen, hashable dtype assignment for one solver configuration."""

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
        """Stock policies by hierarchy-dtype shorthand (see the module
        docstring)."""
        if not isinstance(name, str):
            raise ValueError(f"precision must be a name or policy: {name!r}")
        key = name.strip().lower()
        if key in ("f64", "fp64", "float64", "double"):
            return PrecisionPolicy.double()
        if key in ("f32", "fp32", "float32", "single"):
            return PrecisionPolicy(torch.float32, torch.float32,
                                   torch.float64, torch.float32)
        if key in ("bf16", "bfloat16"):
            return PrecisionPolicy(torch.bfloat16, torch.bfloat16,
                                   torch.float64, torch.float32)
        raise ValueError(
            f"invalid precision {name!r}: expected one of {_NAMES} "
            f"(from REPRO_TORCH_PRECISION or the precision= knob)")

    @property
    def mixed(self) -> bool:
        """True when the hierarchy is stored below the Krylov dtype: the
        solve then keeps a krylov-dtype copy of the finest operator
        (``Hierarchy.a_fine_ell``) for the outer iteration."""
        return self.hierarchy_dtype != self.krylov_dtype

    @property
    def factor_dtype(self) -> torch.dtype:
        """Dtype of the dense factorizations (diag inverses, coarse
        Cholesky): sub-f32 hierarchies factor at the accumulator dtype and
        store the result at ``hierarchy_dtype``."""
        if self.hierarchy_dtype in (torch.float32, torch.float64):
            return self.hierarchy_dtype
        return self.accum_dtype

    @property
    def kernel_accum_dtype(self):
        """``accum_dtype=`` knob of the blocked kernels: ``None`` (native
        accumulation) unless the hierarchy runs below the accumulator."""
        if self.hierarchy_dtype.itemsize < self.accum_dtype.itemsize:
            return self.accum_dtype
        return None

    def coarse_jitter_scale(self) -> float:
        """Relative diagonal jitter of the coarse Cholesky: f64 keeps
        1e-12; reduced-precision chains carry O(eps) rounding into the
        coarse operator, so the guard scales with the factor's eps."""
        if self.hierarchy_dtype == torch.float64:
            return 1e-12
        return 100.0 * float(torch.finfo(self.factor_dtype).eps)

    def coarse_retry_scale(self) -> float:
        """Escalated jitter of the one coarse-Cholesky retry:
        ``sqrt(eps)`` of the factor dtype, taken at that dtype."""
        eps = torch.tensor(torch.finfo(self.factor_dtype).eps,
                           dtype=self.factor_dtype)
        return float(torch.sqrt(eps))

    def describe(self) -> str:
        return (f"hierarchy={_NP_NAMES[self.hierarchy_dtype]} "
                f"smoother={_NP_NAMES[self.smoother_dtype]} "
                f"krylov={_NP_NAMES[self.krylov_dtype]} "
                f"accum={_NP_NAMES[self.accum_dtype]}")
