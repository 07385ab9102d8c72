"""Finite-element assembly through the blocked COO primitive (torch twin of
``repro.fem.assemble``, host path).

Every element emits a dense grid of 3x3 node-pair blocks, declared once as
block coordinates (``preallocate_coo``); each numeric assembly is one
device segment sum of the block value stream (``set_values_coo``).  The
element blocks are computed on the host by ``element_stiffness`` (numpy,
bitwise the reference's host path) and moved to the device once.  The
reference's device path (``DeviceAssembler``, per-element coefficient
updates) is queued in ROADMAP.md.

Dirichlet handling: clamped nodes are eliminated, so every remaining node
carries a full 3x3 diagonal block and the operator stays SPD.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.block_coo import (
    BlockCOOPlan,
    preallocate_coo,
    set_values_coo,
)
from repro_torch.core.block_csr import BlockCSR
from repro_torch.fem.hex_elasticity import (
    HexMesh,
    element_stiffness,
    hex_mesh,
    rigid_body_modes,
)
from repro_torch.kernels.backend import resolve_device

BS = 3  # displacement components per node


@dataclasses.dataclass
class ElasticityProblem:
    """Assembled reduced system + everything AMG needs."""

    A: BlockCSR              # (n_free*3) x (n_free*3), 3x3 blocks
    b: torch.Tensor          # body-force load on free dofs
    B: torch.Tensor          # (n_free*3, 6) rigid-body near-null space
    mesh: HexMesh
    free_nodes: np.ndarray   # global ids of free nodes
    coo_plan: BlockCOOPlan   # cached: numeric reassembly is one scatter
    values: torch.Tensor     # current block value stream

    @property
    def n(self) -> int:
        return self.A.shape[0]

    def reassemble(self, scale: float | torch.Tensor = 1.0) -> BlockCSR:
        """Hot numeric reassembly (new coefficients, same mesh): one
        MatSetValuesCOO segment sum with the cached plan."""
        return set_values_coo(self.coo_plan, self.values * scale)


def _element_block_stream(mesh: HexMesh, Ke: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Block coordinates + values of every element contribution."""
    nn = mesh.connectivity.shape[1]
    conn = mesh.connectivity                        # (ne, nn)
    rows = np.repeat(conn, nn, axis=1).reshape(-1)   # e,a,b -> conn[e,a]
    cols = np.tile(conn, (1, nn)).reshape(-1)        # e,a,b -> conn[e,b]
    blocks = Ke.reshape(nn, BS, nn, BS).transpose(0, 2, 1, 3)  # (a,b,3,3)
    vals = np.broadcast_to(blocks.reshape(1, nn * nn, BS, BS),
                           (mesh.n_elements, nn * nn, BS, BS))
    return rows, cols, vals.reshape(-1, BS, BS)


def _host_value_stream(mesh: HexMesh, E: np.ndarray,
                       nu: np.ndarray) -> np.ndarray:
    """Value stream for per-element fields (host loop)."""
    nn = mesh.connectivity.shape[1]
    ne = mesh.n_elements
    vals = np.empty((ne, nn * nn, BS, BS))
    for e in range(ne):
        Ke = element_stiffness(mesh.order, mesh.h, float(E[e]),
                               float(nu[e]))
        vals[e] = Ke.reshape(nn, BS, nn, BS).transpose(0, 2, 1, 3) \
                    .reshape(nn * nn, BS, BS)
    return vals.reshape(-1, BS, BS)


def coo_plan(mesh: HexMesh, fix_face: bool = True
             ) -> Tuple[BlockCOOPlan, np.ndarray]:
    """The COO plan of every element's node-pair blocks over the free
    nodes (the z=0 face clamped and eliminated when ``fix_face``), and the
    free nodes' global ids."""
    nn = mesh.connectivity.shape[1]
    conn = mesh.connectivity
    rows = np.repeat(conn, nn, axis=1).reshape(-1)   # e,a,b -> conn[e,a]
    cols = np.tile(conn, (1, nn)).reshape(-1)        # e,a,b -> conn[e,b]
    if fix_face:
        fixed = mesh.coords[:, 2] == 0.0
    else:
        fixed = np.zeros(mesh.n_nodes, dtype=bool)
    free = np.flatnonzero(~fixed)
    # renumber: global node -> free index, fixed -> -1 (the plan drops them)
    renum = np.full(mesh.n_nodes, -1, dtype=np.int64)
    renum[free] = np.arange(len(free))
    plan = preallocate_coo(renum[rows], renum[cols], nbr=len(free),
                           nbc=len(free), br=BS, bc=BS)
    return plan, free


def assemble_elasticity(m: int, order: int = 1, E=1.0, nu=0.3,
                        fix_face: bool = True, path: str = "host",
                        device="cuda") -> ElasticityProblem:
    """Assemble the reduced elasticity operator on an ``m^3`` grid.

    ``E``/``nu`` are scalars or per-element ``(n_elements,)`` arrays.
    ``path="host"`` computes the element blocks in numpy; the reference's
    ``"device"`` path is not ported yet and raises.  The value stream, the
    operator and the vectors live on ``device``.
    """
    if path != "host":
        raise ValueError(f"invalid assembly path {path!r}: repro_torch has "
                         f"the 'host' path (the device assembler is queued "
                         f"in ROADMAP.md)")
    dev = resolve_device(device)
    mesh = hex_mesh(m, order)
    ne = mesh.n_elements
    E_f = np.broadcast_to(np.asarray(E, np.float64), (ne,))
    nu_f = np.broadcast_to(np.asarray(nu, np.float64), (ne,))
    plan, free = coo_plan(mesh, fix_face)
    if np.all(E_f == E_f[0]) and np.all(nu_f == nu_f[0]):
        Ke = element_stiffness(order, mesh.h, float(E_f[0]), float(nu_f[0]))
        _, _, vals = _element_block_stream(mesh, Ke)
    else:
        vals = _host_value_stream(mesh, E_f, nu_f)
    values = torch.as_tensor(np.ascontiguousarray(vals)).to(dev)
    A = set_values_coo(plan, values)

    # uniform body force (0, 0, -1) lumped to nodes
    b = np.zeros((len(free), BS))
    b[:, 2] = -mesh.h ** 3
    B = rigid_body_modes(mesh.coords[free])
    return ElasticityProblem(A=A, b=torch.as_tensor(b.reshape(-1)).to(dev),
                             B=torch.as_tensor(B).to(dev), mesh=mesh,
                             free_nodes=free, coo_plan=plan, values=values)
