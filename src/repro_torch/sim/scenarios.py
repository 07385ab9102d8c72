"""Built-in quasi-static material-evolution scenarios, the march laws
(torch twin of ``repro.sim.scenarios``).

A scenario is the coefficient-update law of the time march: constants
built once on the host and stored on the device, with

* ``init_state()`` — the evolution state (a damage field, or nothing)
  that rides the march carry;
* ``step_fields(state, x, step)`` — from the previous step's solution
  ``x``, the evolution state and the step (a device int32 scalar), the
  per-element fields ``(E, nu)`` the step solves with and the advanced
  state.  It runs on the device and copies nothing from the host.

Both update values only: mesh, boundary conditions and the blocked-COO
plan are fixed, which keeps every step inside the cached-plan reuse model.

``SofteningScenario`` — monotone damage: a per-element damage variable
grows with the local displacement magnitude and knocks ``E`` down; softer
elements displace more, so the field walks away from the setup-time
operator (the workload where adaptive re-coarsening pays).

``ThermalScenario`` — a stateless periodic modulation of ``E`` with a
per-element phase; coefficients return every period, so a frozen
hierarchy stays adequate (the counter-workload).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _element_dof_gather(mesh, free_nodes: np.ndarray) -> np.ndarray:
    """(ne, nn) gather map: element-local node -> padded free-node row.
    Fixed (eliminated) nodes map to row ``n_free``, the zero pad row the
    law appends to the reshaped solution."""
    n_free = len(free_nodes)
    renum = np.full(mesh.n_nodes, n_free, dtype=np.int64)
    renum[free_nodes] = np.arange(n_free)
    return renum[mesh.connectivity]


def _padded_element_displacements(x: torch.Tensor, gather: torch.Tensor,
                                  n_free: int) -> torch.Tensor:
    """(ne, nn, 3) per-element nodal displacements from the flat free-dof
    solution (clamped nodes read the zero pad row)."""
    u = x.reshape(n_free, 3)
    upad = torch.cat([u, torch.zeros((1, 3), dtype=u.dtype,
                                     device=u.device)], dim=0)
    return upad[gather]


def _base_fields(prob):
    """The problem's per-element ``(E, nu)`` on its device (E=1, nu=0.3
    when it carries none)."""
    dev = prob.b.device
    ne = prob.mesh.n_elements
    E0 = prob.E_field if prob.E_field is not None else \
        torch.ones((ne,), dtype=torch.float64, device=dev)
    nu0 = prob.nu_field if prob.nu_field is not None else \
        torch.full((ne,), 0.3, dtype=torch.float64, device=dev)
    return E0, nu0


@dataclasses.dataclass(frozen=True, eq=False)
class SofteningScenario:
    """Monotone damage softening: ``E = E0 * (1 - damage(x))``.

    ``damage' = clip(damage + rate * s_e, 0, d_max)`` with ``s_e`` the
    element-mean nodal displacement magnitude: damage never heals, and the
    cap keeps the operator SPD with a contrast of at most
    ``1 / (1 - d_max)``."""

    E0: torch.Tensor         # (ne,) baseline stiffness
    nu0: torch.Tensor        # (ne,) Poisson ratio (damage leaves it alone)
    gather: torch.Tensor     # (ne, nn) int64 element-dof gather map
    n_free: int
    rate: float = 0.01       # damage per unit element displacement a step
    d_max: float = 0.99      # damage cap

    @classmethod
    def build(cls, prob, *, rate: float = 0.01, d_max: float = 0.99
              ) -> "SofteningScenario":
        """From an assembled ``ElasticityProblem``, on its device."""
        E0, nu0 = _base_fields(prob)
        gather = torch.as_tensor(
            _element_dof_gather(prob.mesh, prob.free_nodes)).to(E0.device)
        return cls(E0=E0, nu0=nu0, gather=gather,
                   n_free=len(prob.free_nodes), rate=float(rate),
                   d_max=float(d_max))

    def init_state(self) -> torch.Tensor:
        """Damage field, initially pristine."""
        return torch.zeros_like(self.E0)

    def step_fields(self, state: torch.Tensor, x: torch.Tensor, step):
        ue = _padded_element_displacements(x, self.gather, self.n_free)
        s_e = torch.linalg.vector_norm(ue, dim=-1).mean(dim=-1)   # (ne,)
        damage = torch.clamp(state + self.rate * s_e, 0.0, self.d_max)
        return self.E0 * (1.0 - damage), self.nu0, damage


@dataclasses.dataclass(frozen=True, eq=False)
class ThermalScenario:
    """Thermal-stress cycling: ``E = E0 * (1 + amp * sin(2 pi t / period +
    phase))`` with a per-element phase from the element centroid —
    stateless, periodic, independent of the solution."""

    E0: torch.Tensor         # (ne,)
    nu0: torch.Tensor        # (ne,)
    phase: torch.Tensor      # (ne,) per-element phase offsets
    amp: float = 0.3         # relative modulation amplitude (< 1)
    period: float = 8.0      # steps per cycle

    @classmethod
    def build(cls, prob, *, amp: float = 0.3, period: float = 8.0
              ) -> "ThermalScenario":
        from repro_torch.fem.assemble import element_centroids
        E0, nu0 = _base_fields(prob)
        c = element_centroids(prob.mesh)
        phase = 2.0 * np.pi * c.sum(axis=1) / max(c.sum(axis=1).max(), 1.0)
        return cls(E0=E0, nu0=nu0,
                   phase=torch.as_tensor(phase).to(E0.device),
                   amp=float(amp), period=float(period))

    def init_state(self):
        """No evolution state (an empty node of the carry)."""
        return ()

    def step_fields(self, state, x: torch.Tensor, step: torch.Tensor):
        t = step.to(self.E0.dtype)
        mod = 1.0 + self.amp * torch.sin(
            2.0 * math.pi * t / self.period + self.phase)
        return self.E0 * mod, self.nu0, state
