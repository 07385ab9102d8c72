"""Finite-element assembly through the blocked COO primitive (torch twin of
``repro.fem.assemble``).

Every element emits a dense grid of 3x3 node-pair blocks, declared once as
block coordinates (``preallocate_coo``); each numeric assembly is one
device segment sum of the block value stream (``set_values_coo``).  Two
paths share the one plan:

``path="device"`` (default)
    per-element stiffness blocks computed on the device by batched
    quadrature (``fem.device_stiffness``) from per-element material fields
    ``E(x), nu(x)``.  The problem carries a ``DeviceAssembler``, whose
    ``coo_data(E, nu)`` feeds ``gamg.recompute`` in the coefficient hot
    loop (``ElasticityProblem.update_coefficients``,
    ``GAMGSolver.update_coefficients``).
``path="host"``
    the numpy golden path: one ``element_stiffness`` per distinct material
    (bitwise the reference's host path), moved to the device once.

Coefficient fields are per element (sampled e.g. at ``element_centroids``);
scalars broadcast.  Updates change values only: mesh, boundary conditions
and the COO plan stay fixed.

Dirichlet handling: clamped nodes are eliminated, so every remaining node
carries a full 3x3 diagonal block and the operator stays SPD.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.block_coo import (
    BlockCOOPlan,
    preallocate_coo,
    set_values_coo,
)
from repro_torch.core.block_csr import BlockCSR
from repro_torch.fem.device_stiffness import DeviceAssembler
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
    assembler: Optional[DeviceAssembler] = None   # device path only
    E_field: Optional[torch.Tensor] = None   # current per-element fields
    nu_field: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.A.shape[0]

    def reassemble(self, scale: float | torch.Tensor = 1.0) -> BlockCSR:
        """Hot numeric reassembly (new coefficients, same mesh): one
        MatSetValuesCOO segment sum with the cached plan."""
        return set_values_coo(self.coo_plan, self.values * scale)

    # ---- coefficient updates (device path) ------------------------------
    def _device_assembler(self) -> DeviceAssembler:
        if self.assembler is None:
            raise ValueError(
                "coefficient updates need the device assembly path: "
                "assemble with path='device' (the default)")
        return self.assembler

    def coefficient_operator(self, E, nu) -> BlockCSR:
        """The operator of new per-element fields (device quadrature ->
        cached COO scatter); the problem is left as it was."""
        asm = self._device_assembler()
        E, nu = asm.as_fields(E, nu)
        return set_values_coo(self.coo_plan, asm.value_stream(E, nu))

    def update_coefficients(self, E, nu) -> BlockCSR:
        """In-place coefficient update: new material fields, same mesh and
        plan.  Refreshes ``A``, ``values``, ``E_field`` and ``nu_field``
        and returns the new operator."""
        asm = self._device_assembler()
        E, nu = asm.as_fields(E, nu)
        stream = asm.value_stream(E, nu)
        self.A = set_values_coo(self.coo_plan, stream)
        self.values = stream
        self.E_field, self.nu_field = E, nu
        return self.A


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


def element_centroids(mesh: HexMesh) -> np.ndarray:
    """(n_elements, 3) element centroid coordinates — sample material
    functions here to make per-element coefficient fields."""
    return mesh.coords[mesh.connectivity].mean(axis=1)


def inclusion_fields(mesh: HexMesh, *, E_matrix: float = 1.0,
                     E_inclusion: float = 10.0, nu_matrix: float = 0.3,
                     nu_inclusion: float = 0.2,
                     center=(0.7, 0.7, 0.7), radius: float = 0.3
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-material test problem: a stiff spherical inclusion in a softer
    matrix (numpy per-element fields)."""
    c = element_centroids(mesh)
    inside = np.sum((c - np.asarray(center)) ** 2, axis=1) <= radius ** 2
    E = np.where(inside, E_inclusion, E_matrix)
    nu = np.where(inside, nu_inclusion, nu_matrix)
    return E, nu


def assemble_elasticity(m: int, order: int = 1, E=1.0, nu=0.3,
                        fix_face: bool = True, path: str = "device",
                        device="cuda") -> ElasticityProblem:
    """Assemble the reduced elasticity operator on an ``m^3`` grid.

    ``E``/``nu`` are scalars or per-element ``(n_elements,)`` arrays.
    ``path="device"`` (default) computes the element blocks on ``device``
    by batched quadrature and carries a ``DeviceAssembler`` for
    coefficient updates; ``path="host"`` computes them in numpy.  The value
    stream, the operator and the vectors live on ``device``.
    """
    if path not in ("device", "host"):
        raise ValueError(f"invalid assembly path {path!r}: expected "
                         f"'device' or 'host'")
    dev = resolve_device(device)
    mesh = hex_mesh(m, order)
    ne = mesh.n_elements
    E_f = np.broadcast_to(np.asarray(E, np.float64), (ne,))
    nu_f = np.broadcast_to(np.asarray(nu, np.float64), (ne,))
    plan, free = coo_plan(mesh, fix_face)
    assembler = E_dev = nu_dev = None
    if path == "device":
        assembler = DeviceAssembler.build(mesh, plan, dev)
        E_dev, nu_dev = assembler.as_fields(E_f, nu_f)
        values = assembler.value_stream(E_dev, nu_dev)
    else:
        if np.all(E_f == E_f[0]) and np.all(nu_f == nu_f[0]):
            Ke = element_stiffness(order, mesh.h, float(E_f[0]),
                                   float(nu_f[0]))
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
                             free_nodes=free, coo_plan=plan, values=values,
                             assembler=assembler, E_field=E_dev,
                             nu_field=nu_dev)
