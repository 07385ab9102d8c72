"""Q1 hexahedral linear elasticity on the unit cube, written out plainly.

The mesh has ``m`` nodes per edge, node ``(ix, iy, iz)`` numbered
``ix + m*(iy + m*iz)``, element ``(ex, ey, ez)`` numbered
``ex + (m-1)*(ey + (m-1)*ez)`` with local corner ``(a, b, c)`` at
``a + 2b + 4c``.  The nodes of the ``z = 0`` face are clamped and
eliminated, so free node ``g`` is unknown block ``g - m*m``.

An isotropic element matrix is linear in the Lame parameters,
``Ke = lam * K_LAM + mu * K_MU``, with both unit matrices integrated by the
2x2x2 Gauss rule on the cube of edge ``h``.  Plain NumPy and PyTorch only.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from amgbench.reference.blocked import Blocked

BS = 3
#: the 27 neighbour offsets of a node, in a fixed order
OFFSETS = np.array(list(itertools.product((-1, 0, 1), repeat=3)))[:, ::-1]


def unit_element_matrices(h: float) -> tuple[np.ndarray, np.ndarray]:
    """``(K_LAM, K_MU)``, the 24x24 Q1 stiffness of unit ``lam`` and unit
    ``mu`` on a cube of edge ``h`` (dof ``3*corner + component``)."""
    corners = np.array([(a, b, c) for c in (0, 1) for b in (0, 1)
                        for a in (0, 1)], dtype=np.float64) * 2.0 - 1.0
    g = 1.0 / np.sqrt(3.0)
    k_lam = np.zeros((24, 24))
    k_mu = np.zeros((24, 24))
    w = (h / 2.0) ** 3
    for q in itertools.product((-g, g), repeat=3):
        q = np.asarray(q)
        lin = 1.0 + corners * q                       # (8, 3)
        grad = np.empty((8, 3))
        for d in range(3):
            others = [e for e in range(3) if e != d]
            grad[:, d] = corners[:, d] * lin[:, others[0]] \
                * lin[:, others[1]] / 8.0 * (2.0 / h)
        # displacement gradient G[i, j] = du_i/dx_j as a (9, 24) map
        G = np.zeros((3, 3, 24))
        for n in range(8):
            for i in range(3):
                G[i, :, 3 * n + i] = grad[n]
        div = G[0, 0] + G[1, 1] + G[2, 2]
        sym = 0.5 * (G + G.transpose(1, 0, 2))        # strain tensor
        k_lam += w * np.outer(div, div)
        k_mu += w * 2.0 * np.einsum("ijp,ijq->pq", sym, sym)
    return k_lam, k_mu


def lame(E: torch.Tensor, nu: torch.Tensor):
    return E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))


def element_nodes(m: int) -> np.ndarray:
    """(n_elements, 8) global node ids of every element's corners."""
    ne = m - 1
    e = np.arange(ne ** 3)
    ex, ey, ez = e % ne, (e // ne) % ne, e // (ne * ne)
    out = np.empty((ne ** 3, 8), dtype=np.int64)
    for c in range(2):
        for b in range(2):
            for a in range(2):
                out[:, a + 2 * b + 4 * c] = (ex + a) + m * ((ey + b)
                                                          + m * (ez + c))
    return out


def element_centroids(m: int) -> np.ndarray:
    """(n_elements, 3) centroids, element order as ``element_nodes``."""
    ne = m - 1
    e = np.arange(ne ** 3)
    idx = np.stack([e % ne, (e // ne) % ne, e // (ne * ne)], axis=1)
    return (idx + 0.5) / ne


def free_coords(m: int) -> np.ndarray:
    """(n_free, 3) coordinates of the free nodes, in unknown order."""
    g = np.arange(m * m, m ** 3)
    return np.stack([g % m, (g // m) % m, g // (m * m)], axis=1) / (m - 1.0)


def rigid_body_modes(m: int) -> np.ndarray:
    """(3 * n_free, 6): three translations and three rotations."""
    x = free_coords(m)
    x = x - x.mean(axis=0)
    n = len(x)
    B = np.zeros((n, 3, 6))
    B[:, 0, 0] = B[:, 1, 1] = B[:, 2, 2] = 1.0
    # rotation about axis d: u = e_d x (x - c)
    for d in range(3):
        e = np.zeros(3)
        e[d] = 1.0
        B[:, :, 3 + d] = np.cross(e, x)
    return B.reshape(3 * n, 6)


def assemble(m: int, E: torch.Tensor, nu: torch.Tensor) -> Blocked:
    """The assembled fine operator of per-element fields ``E``, ``nu``
    (shape ``(n_elements,)``, on the device to assemble on), clamped nodes
    eliminated: blocks ``(n_free, 27 neighbour slots)`` summed in place,
    then kept where the neighbour exists."""
    dev = E.device
    h = 1.0 / (m - 1)
    k_lam, k_mu = (torch.as_tensor(k, device=dev)
                   .reshape(8, BS, 8, BS).permute(0, 2, 1, 3)
                   for k in unit_element_matrices(h))
    lam, mu = lame(E.to(torch.float64), nu.to(torch.float64))
    nodes = element_nodes(m)
    n_free = m ** 3 - m * m
    slot_of = {tuple(o): s for s, o in enumerate(OFFSETS)}
    acc = torch.zeros((n_free * 27, BS, BS), dtype=torch.float64, device=dev)
    corner = np.array([(a, b, c) for c in (0, 1) for b in (0, 1)
                       for a in (0, 1)])
    for i in range(8):
        for j in range(8):
            row = nodes[:, i] - m * m
            keep = row >= 0
            if not keep.any():
                continue
            slot = slot_of[tuple(corner[j] - corner[i])]
            blocks = (lam[:, None, None] * k_lam[i, j]
                      + mu[:, None, None] * k_mu[i, j])
            dst = torch.as_tensor(row[keep] * 27 + slot, device=dev)
            acc.index_add_(0, dst, blocks[torch.as_tensor(keep, device=dev)])
    # neighbour columns; a slot exists when its node is in the grid and free
    g = np.arange(m * m, m ** 3)
    xyz = np.stack([g % m, (g // m) % m, g // (m * m)], axis=1)
    nb = xyz[:, None, :] + OFFSETS[None]              # (n_free, 27, 3)
    ok = ((nb >= 0) & (nb < m)).all(axis=2) & (nb[..., 2] >= 1)
    col = nb[..., 0] + m * (nb[..., 1] + m * nb[..., 2]) - m * m
    rows = np.repeat(np.arange(n_free), 27).reshape(n_free, 27)
    flat = torch.as_tensor(np.flatnonzero(ok.reshape(-1)), device=dev)
    return Blocked(torch.as_tensor(rows[ok], device=dev),
                   torch.as_tensor(col[ok], device=dev), acc[flat],
                   n_free, n_free)


def body_force(m: int, device) -> torch.Tensor:
    """The load ``(0, 0, -h^3)`` at every free node."""
    n_free = m ** 3 - m * m
    b = torch.zeros((n_free, BS), dtype=torch.float64, device=device)
    b[:, 2] = -(1.0 / (m - 1)) ** 3
    return b.reshape(-1)
