"""3D hexahedral linear elasticity — the paper's model problem (numpy twin
of ``repro.fem.hex_elasticity``, kept as the port's own copy).

Analogue of PETSc's ``src/ksp/ksp/tutorials/ex56``: isotropic material,
uniform grid, one face clamped.  bs = 3 displacement components per node;
the near-null space is the six rigid-body modes, so the AMG coarse block
size is 6 and the prolongator blocks are 3x6.  Everything here is host
numpy and bitwise the reference's.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Reference-element machinery (tensor-product Lagrange, order 1 or 2)
# ---------------------------------------------------------------------------

def _lagrange_1d(order: int):
    """Nodes, shape functions and derivatives of 1D Lagrange basis."""
    if order == 1:
        pts = np.array([-1.0, 1.0])
    elif order == 2:
        pts = np.array([-1.0, 0.0, 1.0])
    else:
        raise ValueError(f"unsupported order {order}")

    def shape(xi):
        vals = np.ones((len(pts), np.size(xi)))
        derv = np.zeros((len(pts), np.size(xi)))
        xi = np.atleast_1d(xi)
        for i, pi in enumerate(pts):
            others = [p for j, p in enumerate(pts) if j != i]
            denom = np.prod([pi - p for p in others])
            vals[i] = np.prod([xi - p for p in others], axis=0) / denom
            d = np.zeros_like(xi)
            for k in range(len(others)):
                term = np.ones_like(xi)
                for l, p in enumerate(others):
                    if l != k:
                        term = term * (xi - p)
                d = d + term
            derv[i] = d / denom
        return vals, derv

    return pts, shape


def _gauss_1d(npts: int):
    if npts == 2:
        a = 1.0 / np.sqrt(3.0)
        return np.array([-a, a]), np.array([1.0, 1.0])
    if npts == 3:
        a = np.sqrt(3.0 / 5.0)
        return np.array([-a, 0.0, a]), np.array([5, 8, 5]) / 9.0
    raise ValueError(npts)


def lame_parameters(E, nu):
    """Lame (lambda, mu) from Young's modulus / Poisson ratio.

    Plain arithmetic, so it serves numpy scalars and arrays alike.
    """
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    return lam, mu


#: Constitutive basis (Voigt: xx, yy, zz, xy, yz, zx): the isotropic D
#: matrix is linear in the Lame parameters, D = lam*D_LAM + mu*D_MU.
D_LAM = np.zeros((6, 6))
D_LAM[:3, :3] = 1.0
D_MU = np.zeros((6, 6))
D_MU[:3, :3] = 2 * np.eye(3)
D_MU[3:, 3:] = np.eye(3)
for _c in (D_LAM, D_MU):
    _c.flags.writeable = False


def isotropic_d_matrix(E: float, nu: float) -> np.ndarray:
    """6x6 constitutive matrix (Voigt: xx, yy, zz, xy, yz, zx)."""
    lam, mu = lame_parameters(E, nu)
    return lam * D_LAM + mu * D_MU


@lru_cache(maxsize=8)
def element_quadrature(order: int, h: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Quadrature-point strain matrices of the cube reference element.

    Returns ``(B, w)``: ``B`` is ``(nq, 6, 3*nn)`` — the strain-displacement
    matrix at every Gauss point — and ``w`` the ``(nq,)`` quadrature weights
    with the (constant, uniform-grid) Jacobian determinant folded in, so

        Ke(E, nu) = sum_q w[q] * B[q].T @ D(E, nu) @ B[q].
    """
    pts1d, shape1d = _lagrange_1d(order)
    nn1 = len(pts1d)
    nn = nn1 ** 3
    gp, gw = _gauss_1d(order + 1)
    scale = 2.0 / h                       # d(ref)/d(phys)
    detJ = (h / 2.0) ** 3
    Bs, ws = [], []
    for ig, (xi, wx) in enumerate(zip(gp, gw)):
        Nx, dNx = shape1d(np.array([xi]))
        for jg, (eta, wy) in enumerate(zip(gp, gw)):
            Ny, dNy = shape1d(np.array([eta]))
            for kg, (zeta, wz) in enumerate(zip(gp, gw)):
                Nz, dNz = shape1d(np.array([zeta]))
                # node (a,b,c) -> index a + nn1*(b + nn1*c), x fastest
                gx = np.einsum("a,b,c->abc", dNx[:, 0], Ny[:, 0],
                               Nz[:, 0]).reshape(-1, order="F")
                gy = np.einsum("a,b,c->abc", Nx[:, 0], dNy[:, 0],
                               Nz[:, 0]).reshape(-1, order="F")
                gz = np.einsum("a,b,c->abc", Nx[:, 0], Ny[:, 0],
                               dNz[:, 0]).reshape(-1, order="F")
                grad = np.stack([gx, gy, gz], axis=0) * scale  # (3, nn)
                B = np.zeros((6, 3 * nn))
                B[0, 0::3] = grad[0]
                B[1, 1::3] = grad[1]
                B[2, 2::3] = grad[2]
                B[3, 0::3] = grad[1]
                B[3, 1::3] = grad[0]
                B[4, 1::3] = grad[2]
                B[4, 2::3] = grad[1]
                B[5, 0::3] = grad[2]
                B[5, 2::3] = grad[0]
                Bs.append(B)
                ws.append(wx * wy * wz * detJ)
    Bq, wq = np.stack(Bs, axis=0), np.asarray(ws)
    Bq.flags.writeable = False
    wq.flags.writeable = False
    return Bq, wq


@lru_cache(maxsize=8)
def element_stiffness(order: int, h: float, E: float = 1.0,
                      nu: float = 0.3) -> np.ndarray:
    """(3*nn x 3*nn) stiffness of a cube element with edge ``h``.

    Uniform grids make the Jacobian constant (h/2 * I), so one element
    matrix serves every element sharing (E, nu) — the same economy ex56
    exploits.
    """
    Bq, wq = element_quadrature(order, h)
    D = isotropic_d_matrix(E, nu)
    Ke = np.zeros((Bq.shape[2], Bq.shape[2]))
    for B, w in zip(Bq, wq):
        Ke += w * (B.T @ D @ B)
    return 0.5 * (Ke + Ke.T)              # symmetrize roundoff


@dataclasses.dataclass(frozen=True)
class HexMesh:
    """Uniform hex mesh of the unit cube with ``m`` nodes per edge (Q1
    node count; Q2 uses the same elements with midside nodes)."""

    order: int
    n1: int                  # nodes per edge
    ne: int                  # elements per edge
    coords: np.ndarray       # (n_nodes, 3)
    connectivity: np.ndarray  # (n_elements, nn) global node ids
    h: float                 # element edge length

    @property
    def n_nodes(self) -> int:
        return self.n1 ** 3

    @property
    def n_elements(self) -> int:
        return self.ne ** 3


def hex_mesh(m: int, order: int = 1) -> HexMesh:
    """``m^3`` *grid* (element-corner) resolution; Q2 adds midside nodes.

    For order=1 this is the paper's ``m^3`` node grid; for order=2 the node
    grid is ``(2(m-1)+1)^3``, matching a DMPlex -petscfe_degree 2 refine.
    """
    ne = m - 1
    n1 = order * ne + 1
    h = 1.0 / ne
    xs = np.linspace(0.0, 1.0, n1)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    coords = np.stack([X.reshape(-1, order="F"), Y.reshape(-1, order="F"),
                       Z.reshape(-1, order="F")], axis=1)
    # global id = x + n1*(y + n1*z) with x fastest (order="F" reshape above)
    nn1 = order + 1
    conn = np.empty((ne ** 3, nn1 ** 3), dtype=np.int64)
    e = 0
    for kz in range(ne):
        for jy in range(ne):
            for ix in range(ne):
                base_x, base_y, base_z = order * ix, order * jy, order * kz
                local = 0
                for c in range(nn1):
                    for b in range(nn1):
                        for a in range(nn1):
                            gid = ((base_x + a)
                                   + n1 * ((base_y + b)
                                           + n1 * (base_z + c)))
                            # local index a + nn1*(b + nn1*c): x fastest,
                            # matching element_stiffness ordering
                            conn[e, a + nn1 * (b + nn1 * c)] = gid
                            local += 1
                e += 1
    return HexMesh(order=order, n1=n1, ne=ne, coords=coords,
                   connectivity=conn, h=h)


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """(3*n, 6) rigid-body near-null space (paper Sec. 2.2).

    Columns: 3 translations + 3 rotations about the centroid.
    """
    c = coords - coords.mean(axis=0)
    n = len(c)
    B = np.zeros((3 * n, 6))
    B[0::3, 0] = 1.0
    B[1::3, 1] = 1.0
    B[2::3, 2] = 1.0
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    B[1::3, 3] = -z
    B[2::3, 3] = y
    B[0::3, 4] = z
    B[2::3, 4] = -x
    B[0::3, 5] = -y
    B[1::3, 5] = x
    return B


def nnz_per_row_estimate(order: int) -> int:
    """Scalar nonzeros per row (paper Sec. 4.6): ~81 for Q1 (27 node
    neighbours x 3 dofs), ~187 for Q2."""
    return 81 if order == 1 else 187
