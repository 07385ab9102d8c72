"""The paper's own configuration: 3D Q1 hex elasticity + GAMG (the port's
copy of ``repro.configs.elasticity``).

Sec. 4.1's setup: block size 3, GAMG with a pbjacobi-preconditioned
Chebyshev smoother and a CG accelerator, unpreconditioned residual norm,
interpolation reused across solves (PETSc
``-pc_gamg_reuse_interpolation``).  ``CONFIG`` is the one-device rung of
the paper's weak-scaling ladder (98 304 unknowns per device).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ElasticityConfig:
    m: int                       # grid nodes per edge (m^3 node grid)
    order: int = 1               # 1 = Q1 (paper main)
    E: float = 1.0               # Young's modulus
    nu: float = 0.3              # Poisson ratio
    theta: float = 0.08          # strength-of-connection threshold
    smoother: str = "chebyshev"  # pbjacobi-preconditioned (paper default)
    degree: int = 2
    coarse_size: int = 100
    coarsener: str = "greedy"
    rtol: float = 1e-8           # unpreconditioned residual norm
    maxiter: int = 200

    def build(self, device="cuda"):
        """Assemble the problem (host element blocks) and the solver (cold
        setup) on ``device``."""
        from repro_torch.core.gamg import GAMGSolver
        from repro_torch.fem.assemble import assemble_elasticity
        prob = assemble_elasticity(self.m, order=self.order, E=self.E,
                                   nu=self.nu, path="host", device=device)
        solver = GAMGSolver(prob.A, prob.B, theta=self.theta,
                            smoother=self.smoother, degree=self.degree,
                            coarse_size=self.coarse_size,
                            coarsener=self.coarsener, rtol=self.rtol,
                            maxiter=self.maxiter)
        return prob, solver


CONFIG = ElasticityConfig(m=32)
