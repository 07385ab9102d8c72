"""Device-resident element stiffness — batched quadrature over elements
(torch twin of ``repro.fem.device_stiffness``).

The host path (``hex_elasticity.element_stiffness``) builds one numpy
``Ke`` per distinct material.  This module computes **per-element**
stiffness blocks on the device from material fields ``E(x), nu(x)`` given
as per-element arrays, so the quasi-static hot loop

    update_coefficients(E, nu) -> COO scatter-sum -> gamg.recompute -> solve

moves only the two fields to the card.

* ``DeviceAssembler`` is the cold, host-built symbolic side: the shared
  quadrature arrays (``hex_elasticity.element_quadrature``, the host
  path's B matrices) on the device, the element count and the cached
  ``BlockCOOPlan``.  Built once per mesh and boundary conditions.
* ``element_stiffness_blocks`` / ``element_value_stream`` /
  ``value_stream`` / ``coo_data`` are functions of the coefficient fields
  on the device (the first two also serve the distributed rank assembly,
  ``repro_torch.dist.solver._rank_assemble``).  The constitutive
  matrix is linear in the Lame parameters (``D = lam*D_LAM + mu*D_MU``),
  so heterogeneity costs one broadcast.  The quadrature is a small dense
  contraction (24x24 per element) that the reference also leaves to its
  compiler: here it is two batched ``torch.matmul``; the scatter-sum is
  the ``block_seg_sum`` kernel.

Everything runs at f64.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.block_coo import BlockCOOPlan, set_values_coo_data
from repro_torch.fem.hex_elasticity import (
    D_LAM,
    D_MU,
    HexMesh,
    element_quadrature,
    lame_parameters,
)
from repro_torch.obs import trace as obs_trace

BS = 3  # displacement components per node


@functools.lru_cache(maxsize=None)
def _constitutive_basis(dtype, device):
    """``D_LAM`` and ``D_MU`` on ``device``, copied there once (so a
    coefficient update moves nothing to the device but its fields)."""
    return (torch.tensor(D_LAM, dtype=dtype, device=device),
            torch.tensor(D_MU, dtype=dtype, device=device))


def element_stiffness_blocks(Bq: torch.Tensor, wq: torch.Tensor,
                             E: torch.Tensor, nu: torch.Tensor
                             ) -> torch.Tensor:
    """Per-element stiffness matrices by batched quadrature.

    ``Bq (nq, 6, 3*nn)`` / ``wq (nq,)`` are the shared quadrature arrays;
    ``E``/``nu`` per-element ``(ne,)`` fields, all on one device.  Returns
    the ``(ne, 3*nn, 3*nn)`` symmetric element matrices

        Ke_e = sum_q w_q B_q^T (lam_e D_LAM + mu_e D_MU) B_q
    """
    dl, dm = _constitutive_basis(Bq.dtype, Bq.device)
    lam, mu = lame_parameters(E, nu)
    D = lam[:, None, None] * dl + mu[:, None, None] * dm       # (ne, 6, 6)
    nq, nv, nd = Bq.shape
    DB = torch.matmul(D[:, None], Bq[None])              # (ne, nq, 6, nd)
    WB = (wq[:, None, None] * Bq).reshape(nq * nv, nd)   # (nq*6, nd)
    Ke = torch.matmul(WB.T, DB.reshape(-1, nq * nv, nd))  # (ne, nd, nd)
    return 0.5 * (Ke + Ke.transpose(1, 2))                # mirror host path


def element_value_stream(Bq: torch.Tensor, wq: torch.Tensor,
                         E: torch.Tensor, nu: torch.Tensor, nn: int
                         ) -> torch.Tensor:
    """``(ne*nn*nn, 3, 3)`` blocked value stream of the elements' stiffness
    blocks, element-major, then row node, then column node (the order the
    COO plans declare their coordinates in)."""
    Ke = element_stiffness_blocks(Bq, wq, E, nu)
    return Ke.reshape(-1, nn, BS, nn, BS).permute(0, 1, 3, 2, 4) \
        .reshape(-1, BS, BS)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceAssembler:
    """Cold symbolic side of device assembly (host-built; ``eq=False``
    keeps the identity hash).

    Owns the quadrature arrays on ``device``, the element bookkeeping and
    the cached ``BlockCOOPlan`` of the reduced (BC-eliminated) operator;
    the numeric side is ``value_stream`` / ``coo_data`` of the fields.
    """

    plan: BlockCOOPlan
    quad_b: torch.Tensor    # (nq, 6, 3*nn) strain matrices
    quad_w: torch.Tensor    # (nq,) weights * detJ
    n_elements: int
    nn: int                 # nodes per element

    @property
    def device(self) -> torch.device:
        return self.quad_b.device

    @staticmethod
    def build(mesh: HexMesh, plan: BlockCOOPlan,
              device) -> "DeviceAssembler":
        Bq, wq = element_quadrature(mesh.order, mesh.h)
        return DeviceAssembler(
            plan=plan, quad_b=torch.tensor(Bq, device=device),
            quad_w=torch.tensor(wq, device=device),
            n_elements=mesh.n_elements, nn=mesh.connectivity.shape[1])

    # ---- field plumbing -------------------------------------------------
    def as_fields(self, E, nu):
        """Scalars, numpy arrays or tensors -> per-element ``(ne,)`` f64
        fields on the assembler's device (one host-to-device copy of each
        field that is not there yet)."""
        return self._field(E), self._field(nu)

    def _field(self, v) -> torch.Tensor:
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(np.asarray(v, np.float64))
        v = v.to(device=self.device, dtype=torch.float64)
        return v.expand(self.n_elements).contiguous()

    # ---- numeric phase ---------------------------------------------------
    def element_blocks(self, E: torch.Tensor, nu: torch.Tensor
                       ) -> torch.Tensor:
        """(ne, 3*nn, 3*nn) element matrices of the coefficient fields."""
        return element_stiffness_blocks(self.quad_b, self.quad_w, E, nu)

    def value_stream(self, E: torch.Tensor, nu: torch.Tensor
                     ) -> torch.Tensor:
        """(n_input, 3, 3) blocked COO value stream in declaration order
        (element-major, then row node, then column node) — the stream
        ``self.plan`` was preallocated for."""
        return element_value_stream(self.quad_b, self.quad_w, E, nu,
                                    self.nn)

    def coo_data(self, E: torch.Tensor, nu: torch.Tensor) -> torch.Tensor:
        """Assembled (nnzb, 3, 3) operator payload: the value stream
        through the cached plan's scatter-sum.  Under the observability
        knob, ``assemble/value_stream`` times the quadrature and
        ``assemble/scatter`` the scatter-sum."""
        with obs_trace.span("assemble/value_stream"):
            values = self.value_stream(E, nu)
        with obs_trace.span("assemble/scatter"):
            return set_values_coo_data(self.plan, values)
