"""The plain reference against the port on the CPU at small sizes, and
the reference's own physics."""
import numpy as np
import pytest
import torch

import amgbench_cells  # noqa: F401  (puts the repo and src on the path)
from amgbench.reference import fem
from amgbench.reference.blocked import Blocked, galerkin, relative_gap
from amgbench.reference.judge import Judge


def test_element_matrices_annihilate_rigid_motions():
    k_lam, k_mu = fem.unit_element_matrices(0.25)
    x = np.array([(a, b, c) for c in (0, 1) for b in (0, 1)
                  for a in (0, 1)], dtype=float) * 0.25
    modes = np.zeros((8, 3, 6))
    modes[:, 0, 0] = modes[:, 1, 1] = modes[:, 2, 2] = 1.0
    for d in range(3):
        e = np.zeros(3)
        e[d] = 1.0
        modes[:, :, 3 + d] = np.cross(e, x)
    modes = modes.reshape(24, 6)
    for k in (k_lam, k_mu):
        assert np.abs(k - k.T).max() < 1e-15
        assert np.abs(k @ modes).max() < 1e-13 * np.abs(k).max()
        assert np.linalg.eigvalsh(k)[0] > -1e-15
    # the shear part is positive on all 18 deformation modes
    assert (np.linalg.eigvalsh(k_mu)[6:] > 1e-3).all()


def test_blocked_products_match_dense():
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 7, (30,), generator=g)
    cols = torch.randint(0, 5, (30,), generator=g)
    A = Blocked.summed(rows, cols, torch.randn(30, 3, 2, generator=g,
                                               dtype=torch.float64), 7, 5)
    P = Blocked.summed(torch.randint(0, 5, (12,), generator=g),
                       torch.randint(0, 4, (12,), generator=g),
                       torch.randn(12, 2, 6, generator=g,
                                   dtype=torch.float64), 5, 4)
    Ad, Pd = A.dense(), P.dense()
    assert torch.allclose(A.matmul(P).dense(), Ad @ Pd, atol=1e-13)
    S = A.transpose().matmul(A)
    assert torch.allclose(galerkin(P, S).dense(), Pd.T @ S.dense() @ Pd,
                          atol=1e-12)
    x = torch.randn(10, 3, dtype=torch.float64, generator=g)
    assert torch.allclose(A.matvec(x), Ad @ x, atol=1e-13)
    assert relative_gap(A, A) == 0.0


def _port(m, coarse_size):
    from repro_torch.configs.elasticity import ElasticityConfig
    return ElasticityConfig(m=m, coarse_size=coarse_size).build("cpu")


@pytest.mark.parametrize("m,coarse_size", [(7, 12), (9, 20)])
def test_reference_matches_port(m, coarse_size):
    prob, solver = _port(m, coarse_size)
    aggs = [ls.aggr.node_to_agg for ls in solver.setup_data.levels]
    j = Judge(m, 1.0, 0.3, aggs, torch.device("cpu"))
    A = j.hierarchy(solver.hierarchy)
    j.solution(A, fem.body_force(m, "cpu"), solver.solve(prob.b).x)
    c = torch.as_tensor(fem.element_centroids(m))
    inside = ((c - torch.tensor([0.4, 0.6, 0.5])) ** 2).sum(1) <= 0.09
    E = torch.where(inside, 10.0, 1.0).double()
    nu = torch.where(inside, 0.2, 0.3).double()
    solver.update_coefficients(E, nu)
    A = j.hierarchy(solver.hierarchy, E, nu)
    j.solution(A, prob.b, solver.solve(prob.b).x)
    w = j.worst
    for name in ("fine_operator", "coarse_operators", "prolongators",
                 "smoother"):
        assert w[name] < 1e-13, (name, w[name])
    assert w["coarse_factor"] < 1e-11      # the factor's 1e-12 jitter
    assert w["residual"] <= 1e-8


def test_reference_mesh_matches_port():
    from repro_torch.fem.assemble import element_centroids
    from repro_torch.fem.hex_elasticity import hex_mesh
    mesh = hex_mesh(6)
    assert np.array_equal(mesh.connectivity, fem.element_nodes(6))
    assert np.abs(element_centroids(mesh) - fem.element_centroids(6)).max() \
        < 1e-15
